"""The LSTM forward's profile script on the CPU.

``sketch_rnn_tpu_torch/scripts/profile_lstm_fwd.py`` builds
``csrc/fused_rnn.cu`` a second time with ``csrc/lstm_loops.cuh`` spliced
in and clock marks inserted at fixed lines of the forward's cooperative
kernel there, and runs that build on the
card. Here, without a card: every mark finds its line (a changed kernel
fails here, not in a chip run), the ``--rows`` builds replace the rows
rule, and the script refuses to run without a card.
"""

import pytest
import torch

from sketch_rnn_tpu_torch.ops import _build
from sketch_rnn_tpu_torch.scripts import profile_lstm_fwd as P


@pytest.mark.parametrize("rows", [None, 2, 4])
def test_instrumented_source_marks_every_phase(rows):
    src = P.instrumented_source(rows)
    assert src.count("mark_(") == len(P.MARKS)
    for i in range(len(P.PHASES)):
        assert f"mark_({i});" in src
    assert 'extern "C" int srt_fwd_profile(' in src
    if rows is None:
        assert P.ROWS_RULE in src
    else:
        assert P.ROWS_RULE not in src
        assert f"  g.rows = {rows};\n" in src
    # the header is spliced in once; the production sources are read,
    # never written
    assert P.HEADER not in src
    assert src.count("\nlstm_fwd_loop_kernel(Fwd<W, R> a") == 1
    for name in ("fused_rnn.cu", "lstm_loops.cuh"):
        assert "mark_(" not in (_build.CSRC / name).read_text()


def test_profile_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        next(P.run())
