"""``serve-bench`` of the port's command line on ``--device cpu``, in
process, at the tiny widths of ``tests/test_fleet.py``.

- The engine path (continuous and ``--static``, at ``--quantize int8``,
  with ``--slo`` and ``--log_metrics``) and the fleet path (two CPU
  replicas, open-loop arrivals, two admission classes, an endpoint mix)
  exit 0, and their reports carry the JAX CLI's keys for the same flags,
  less those of unported features (``UNPORTED``).
- The JAX CLI's usage errors exit 2 before any checkpoint is read, with
  the same message.
- Without a card the default ``--device cuda`` exits 2.
"""

import json

import pytest
import torch

from sketch_rnn_tpu import cli as jcli
from sketch_rnn_tpu_torch import cli

HP = ("batch_size=8,max_seq_len=24,enc_rnn_size=12,dec_rnn_size=16,"
      "z_size=6,num_mixture=3,serve_slots=2,serve_chunk=2")
CPU = ["--device", "cpu"]
# report keys of features the port does not have yet: telemetry and the
# metrics endpoint (run_id, spans, tail, metrics_port, metrics_prom;
# ROADMAP items 7, 5b-ii), and the fleet's elastic and tail blocks
# (5b-ii, 7)
UNPORTED = {"run_id", "spans", "tail", "metrics_port", "metrics_prom"}
UNPORTED_FLEET = {"replicas_retired", "scale_log", "tail"}


def _report(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def _run(main, wd, args, capsys, extra=()):
    assert main(["serve-bench", "--random_init", f"--hparams={HP}",
                 f"--workdir={wd}", *args, *extra]) == 0
    return _report(capsys.readouterr().out)


ENGINE_ARGS = ["-n", "8", "--quantize", "int8", "--slo", "p95<=100",
               "--log_metrics"]


@pytest.fixture(scope="module")
def jax_engine_report(tmp_path_factory):
    """The JAX CLI's engine-path report (its output captured here)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jcli.main(["serve-bench", "--random_init",
                          f"--hparams={HP}", *ENGINE_ARGS,
                          f"--workdir={tmp_path_factory.mktemp('j')}"]) \
            == 0
    return _report(out.getvalue())


@pytest.mark.parametrize("static", [[], ["--static"]])
def test_engine_path_reports_the_jax_keys(tmp_path, capsys,
                                          jax_engine_report, static):
    jrep = jax_engine_report
    trep = _run(cli.main, tmp_path / "port", [*ENGINE_ARGS, *static],
                capsys, CPU)
    assert trep["static"] == bool(static)
    assert set(trep) == set(jrep) - UNPORTED
    for k in ("kind", "n_requests", "slots", "chunk", "param_dtype",
              "quantized_tensors", "completed"):
        assert trep[k] == jrep[k], k
    assert trep["decode_kernel"] == "cuda" and trep["completed"] == 8
    assert trep["slo"]["generate:latency_s:p95"]["total"] == 8
    assert 0 < trep["quantize_max_err"] < 1e-2
    rows = (tmp_path / "port" / "serve_metrics.jsonl").read_text()
    assert len(rows.splitlines()) == 8


def test_fleet_path_reports_the_jax_keys(tmp_path, capsys):
    args = ["-n", "12", "--fleet", "2", "--rate", "400",
            "--classes", "interactive:p95<=250ms",
            "--classes", "batch:p99<=2",
            "--endpoints", "generate=interactive",
            "--endpoints", "complete=interactive",
            "--endpoints", "reconstruct=batch",
            "--endpoints", "interpolate=batch", "--frames", "3",
            "--slo", "interactive:p95<=100", "--quantize", "bfloat16"]
    jrep = _run(jcli.main, tmp_path / "jax", args, capsys)
    trep = _run(cli.main, tmp_path / "port", args, capsys, CPU)
    assert set(trep) == set(jrep) - UNPORTED
    assert set(trep["fleet"]) == set(jrep["fleet"]) - UNPORTED_FLEET
    f = trep["fleet"]
    assert f["replicas"] == 2 and f["offered_rate"] == 400.0
    assert f["submitted"] == 12 == f["completed"] + f["shed"]
    assert f["cost"]["exact"]
    assert set(f["latency_by_class"]) <= {"interactive", "batch"}
    assert f["endpoint_mix"] == jrep["fleet"]["endpoint_mix"]
    assert sum(v["completed"] for v in trep["latency_by_endpoint"]
               .values()) == f["completed"]


@pytest.mark.parametrize("args", [
    ["--rate", "5"],
    ["--classes", "a:p95<=1"],
    ["--slo", "p95"],
    ["--fleet", "--static"],
    ["--fleet", "--classes", "bad"],
    ["--fleet", "--rate", "-1"],
    ["--endpoints", "generate=a"],
    ["--fleet", "--endpoints", "bogus=a"],
    ["--fleet", "--endpoint_mix", "nope:1"],
    ["--fleet", "--endpoints", "complete=a:p95<=1",
     "--endpoints", "reconstruct=b:p95<=1",
     "--endpoint_mix", "complete,reconstruct,generate"],
    ["--fleet", "--endpoints", "complete=a",
     f"--hparams={HP},conditional=false"],
    ["--fleet", "--endpoints", "interpolate=a", "--frames", "1"],
    ["--fleet", "--endpoints", "interpolate=a", "--frames", "99"]])
def test_usage_errors_exit_2_as_in_jax(tmp_path, capsys, args):
    """Before any checkpoint is read (the workdir is empty), with the
    JAX CLI's message."""
    wd = [f"--workdir={tmp_path}"]
    hp = [] if any(a.startswith("--hparams") for a in args) \
        else [f"--hparams={HP}"]
    assert jcli.main(["serve-bench", *hp, *args, *wd]) == 2
    want = capsys.readouterr().err
    assert cli.main(["serve-bench", *hp, *args, *wd, *CPU]) == 2
    assert capsys.readouterr().err == want
    assert not any(tmp_path.iterdir())


def test_pallas_refuses_the_hyper_cell_and_no_card_exits_2(
        tmp_path, capsys, monkeypatch):
    wd = f"--workdir={tmp_path}"
    args = ["serve-bench", "--random_init", "--decode_kernel", "pallas",
            f"--hparams={HP},dec_model=hyper", wd]
    assert jcli.main(args) == 2
    assert "hyper" in capsys.readouterr().err
    assert cli.main([*args, *CPU]) == 2
    assert "'hyper'" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["serve-bench", "--random_init", f"--hparams={HP}",
                     wd]) == 2
    assert "--device cpu" in capsys.readouterr().err
    assert cli.main(["serve-bench", "--random_init", f"--hparams={HP}",
                     "--fleet", wd]) == 2
    assert not any(tmp_path.iterdir())
