"""The HyperLSTM forward's profile script on the CPU.

``sketch_rnn_tpu_torch/scripts/profile_hyper_fwd.py`` builds
``csrc/fused_hyper.cu`` a second time with clock marks inserted at fixed
lines of the forward's loop, and runs that build on the card. Here,
without a card: every mark finds its line (a changed kernel fails here,
not in a chip run), every phase is booked by at least one mark and the
barrier phase by one mark after each of the five grid barriers, and the
script refuses to run without a card.
"""

import pytest
import torch

from sketch_rnn_tpu_torch.ops import _build
from sketch_rnn_tpu_torch.scripts import profile_hyper_fwd as P


def test_instrumented_source_marks_every_phase():
    src = P.instrumented_source()
    barrier = P.PHASES.index("barrier")
    for i, phase in enumerate(P.PHASES):
        assert src.count(f"mark_({i});") == (5 if i == barrier else 1), phase
    # every grid barrier of the loop is followed by its mark
    loop = src[src.index("hyper_fwd_loop_kernel(HyperFwd"):
               src.index("const void* hyper_fwd_fn(")]
    assert loop.count("grid.sync();") == 5
    assert loop.count(f"mark_({barrier});") == 5
    assert "g_prof[blockIdx.x * 16 + q] += prof_[q];" in src
    assert 'extern "C" int srt_hyper_profile(' in src
    # the production source is read, never written
    assert "mark_(" not in (_build.CSRC / "fused_hyper.cu").read_text()


def test_profile_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        next(P.run())
