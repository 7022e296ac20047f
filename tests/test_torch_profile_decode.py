"""The serving loop's profile script on the CPU.

``sketch_rnn_tpu_torch/scripts/profile_decode.py`` builds
``csrc/decode.cu`` a second time with clock marks inserted at fixed lines
of the serving loop, and runs that build on the card. Here, without a
card: every mark finds its line (a changed kernel fails here, not in a chip
run), every phase is booked by at least one mark and the barrier phase by
one mark after each grid barrier of the loop, and the script refuses to
run without a card.
"""

import pytest
import torch

from sketch_rnn_tpu_torch.ops import _build
from sketch_rnn_tpu_torch.scripts import profile_decode as P


def test_instrumented_source_marks_every_phase():
    src = P.instrumented_source()
    loop = src[src.index("serve_loop_kernel(Serve<W> a"):
               src.index("struct ServePlan {")]
    barrier = P.PHASES.index("barrier")
    assert loop.count("grid.sync();") == 5
    assert loop.count(f"mark_({barrier});") == 5
    for i, phase in enumerate(P.PHASES):
        if phase in ("first_products", "products"):
            want = f"mark_(t == 0 ? {P.PHASES.index('first_products')} : " \
                   f"{P.PHASES.index('products')});"
            assert loop.count(want) == 1, phase
        elif phase != "barrier":
            assert loop.count(f"mark_({i});") == (2 if phase == "cell"
                                                  else 1), phase
    assert "g_prof[blockIdx.x * 16 + q] += prof_[q];" in src
    assert 'extern "C" int srt_decode_profile(' in src
    # the production source is read, never written
    assert "mark_(" not in (_build.CSRC / "decode.cu").read_text()


def test_profile_cases_cover_both_policies_cells_and_dtypes():
    assert set(P.CASES) == {(p, c, d) for p in ("decode", "replay")
                            for c in ("layer_norm", "lstm")
                            for d in (torch.float32, torch.bfloat16)}


def test_profile_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        next(P.run())
