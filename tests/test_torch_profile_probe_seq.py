"""The probe loop's profile script on the CPU.

``sketch_rnn_tpu_torch/scripts/profile_probe_seq.py`` builds
``csrc/probe_seq.cu`` a second time with clock marks inserted at fixed
lines of the probe loop, and runs that build on the card. Here, without
a card: every mark finds its line (a changed kernel fails here, not in a
chip run), each phase is booked by exactly one mark, and the script
refuses to run without a card.
"""

import pytest
import torch

from sketch_rnn_tpu_torch.ops import _build
from sketch_rnn_tpu_torch.scripts import profile_probe_seq as P


def test_instrumented_source_marks_every_phase():
    src = P.instrumented_source()
    for i in range(len(P.PHASES)):
        assert src.count(f"mark_({i});") == 1
    assert "g_prof[blockIdx.x * 8 + q] = prof_[q];" in src
    assert 'extern "C" int srt_probe_profile(' in src
    # the production source is read, never written
    assert "mark_(" not in (_build.CSRC / "probe_seq.cu").read_text()


def test_profile_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        next(P.run())
