"""The port's command line (``python -m sketch_rnn_tpu_torch.cli``) on
``--device cpu``, in process, at tiny widths on the synthetic corpus.

- ``train`` -> ``eval`` -> ``sample`` in every mode: exit 0, checkpoint
  format 1 in the workdir, each SVG parses and holds the grid of the
  sketches asked for.
- Either package's ``train`` writes a workdir the other's ``eval`` and
  ``sample`` read. ``sample --interpolate/--reconstruct --strokes_out``
  of the two packages give the same frames (steps and pens exact,
  offsets within 1e-5): both go through their package's
  ``serve_requests``. The port's eval line agrees with the JAX CLI's
  (and with the JAX run's own test sweep) on the step and on
  ``kl_raw``; the loss terms do not: the JAX CLI evaluates on a device
  mesh (here the tests' eight virtual CPU devices), whose step folds its
  key with the axis index (``sketch_rnn_tpu/train/step.py:326``), so its
  ``z`` noise is another draw than the port's, which has no mesh yet
  (ROADMAP queue 1 item 4).
- The JAX CLI's usage checks exit 2 with the same message in the port,
  and every flag or subcommand of an unported feature exits 2 naming
  its ROADMAP item. Without a card the default ``--device cuda`` exits
  2.
"""

import json
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from sketch_rnn_tpu import cli as jcli
from sketch_rnn_tpu_torch import cli

HP = ("batch_size=8,max_seq_len=32,enc_rnn_size=12,dec_rnn_size=16,"
      "z_size=6,num_mixture=3,num_classes=2,serve_slots=4,serve_chunk=4,"
      "num_steps=4,save_every=2,eval_every=2,log_every=2,"
      "eval_steps_per_call=1")
TOL = 1e-5
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def port_workdir(tmp_path_factory):
    wd = tmp_path_factory.mktemp("port") / "work"
    assert cli.main(["train", "--synthetic", f"--workdir={wd}",
                     f"--hparams={HP}", *CPU]) == 0
    return wd


@pytest.fixture(scope="module")
def jax_workdir(tmp_path_factory):
    wd = tmp_path_factory.mktemp("jax") / "work"
    assert jcli.main(["train", "--synthetic", f"--workdir={wd}",
                      "--no_resume", f"--hparams={HP}"]) == 0
    return wd


def _json_line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def _grid(path, n, cols):
    """The SVG at ``path`` parses, and its canvas is the grid of ``n``
    cells of 160 in rows of ``min(cols, n)``; returns its paths."""
    root = ET.parse(path).getroot()
    cols = max(1, min(cols, n))
    rows = -(-n // cols)
    assert (root.get("width"), root.get("height")) == \
        (f"{cols * 160}", f"{rows * 160}")
    return root.findall("{http://www.w3.org/2000/svg}path")


def test_train_writes_a_format_1_workdir(port_workdir):
    for step in (2, 4):
        assert (port_workdir / f"ckpt_{step:08d}.msgpack").exists()
    meta = json.loads((port_workdir / "ckpt_00000004.json").read_text())
    assert meta["step"] == 4 and meta["format_version"] == 1
    assert cli.HParams.from_json(json.dumps(meta["hps"])) == \
        cli.get_default_hparams().parse(HP)


def test_eval_per_class(port_workdir, capsys):
    assert cli.main(["eval", "--synthetic", f"--workdir={port_workdir}",
                     "--split", "test", "--per_class", *CPU]) == 0
    out = _json_line(capsys.readouterr().out)
    assert out["split"] == "test" and out["step"] == 4
    assert np.isfinite(out["loss"]) and sorted(out["per_class"]) == \
        ["0", "1"]


@pytest.mark.parametrize("mode,args,cells,cols", [
    ("plain", ["-n", "6"], 6, 5),
    ("greedy", ["-n", "3", "--greedy", "--cols", "2"], 3, 2),
    ("temperatures", ["-n", "4", "--temperatures", "0.2,0.5,1.0"], 12, 4),
    ("interpolate", ["-n", "5", "--interpolate"], 5, 5),
    ("reconstruct", ["-n", "3", "--reconstruct"], 6, 3)])
def test_sample_modes(port_workdir, tmp_path, capsys, mode, args, cells,
                      cols):
    svg = tmp_path / f"{mode}.svg"
    extra = ([f"--strokes_out={tmp_path / 's.npz'}"]
             if mode in ("interpolate", "reconstruct") else [])
    assert cli.main(["sample", "--synthetic", f"--workdir={port_workdir}",
                     f"--output={svg}", *args, *extra, *CPU]) == 0
    assert "[cli] wrote" in capsys.readouterr().out
    _grid(svg, cells, cols)
    if extra:
        with np.load(tmp_path / "s.npz") as z:
            n = int(args[1])
            assert z.files == [f"strokes5_{i:03d}" for i in range(n)]
            for k in z.files:
                s5 = z[k]
                assert s5.shape[1] == 5 and np.isfinite(s5).all()
                np.testing.assert_array_equal(s5[:, 2:].sum(-1), 1.0)


def _strokes(path):
    with np.load(path) as z:
        return [z[k] for k in z.files]


def _same_frames(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a[:, 2:], b[:, 2:])
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def _port_eval(workdir, capsys) -> dict:
    assert cli.main(["eval", "--synthetic", f"--workdir={workdir}",
                     "--split", "test", *CPU]) == 0
    return _json_line(capsys.readouterr().out)


def _same_samples(workdir, tmp_path, sample_args):
    """``sample ... --strokes_out`` of both packages on one workdir give
    the same frames."""
    base = ["--synthetic", f"--workdir={workdir}", *sample_args]
    for who, main, extra in (("port", cli.main, CPU),
                             ("jax", jcli.main, [])):
        assert main(["sample", *base, f"--output={tmp_path / who}.svg",
                     f"--strokes_out={tmp_path / who}.npz", *extra]) == 0
    _same_frames(_strokes(tmp_path / "port.npz"),
                 _strokes(tmp_path / "jax.npz"))


def test_jax_cli_reads_a_port_workdir(port_workdir, tmp_path, capsys):
    port_ev = _port_eval(port_workdir, capsys)
    assert jcli.main(["eval", "--synthetic", f"--workdir={port_workdir}",
                      "--split", "test"]) == 0
    jax_ev = _json_line(capsys.readouterr().out)
    assert port_ev["step"] == jax_ev["step"] == 4
    assert abs(port_ev["kl_raw"] - jax_ev["kl_raw"]) <= 2e-6
    _same_samples(port_workdir, tmp_path, ["-n", "5", "--interpolate"])


def test_port_cli_reads_a_jax_workdir(jax_workdir, tmp_path, capsys):
    """The port's eval of the JAX run's last checkpoint against the test
    sweep that run wrote at its end; its samples against the JAX CLI's."""
    port_ev = _port_eval(jax_workdir, capsys)
    with open(jax_workdir / "test_metrics.jsonl") as f:
        jax_ev = json.loads(f.read().strip().splitlines()[-1])
    assert port_ev["step"] == jax_ev["step"] == 4
    assert abs(port_ev["kl_raw"] - jax_ev["kl_raw"]) <= 2e-6
    _same_samples(jax_workdir, tmp_path, ["-n", "3", "--reconstruct"])
    assert cli.main(["sample", "--synthetic", f"--workdir={jax_workdir}",
                     "-n", "4", f"--output={tmp_path / 'p.svg'}",
                     *CPU]) == 0
    _grid(tmp_path / "p.svg", 4, 5)


@pytest.mark.parametrize("args", [
    ["sample", "--interpolate", "--hparams=conditional=false"],
    ["sample", "--reconstruct", "--hparams=conditional=false"],
    ["sample", "--strokes_out=x.npz"],
    ["sample", "--interpolate", "-n", "1"],
    ["sample", "--temperatures=0.5", "--reconstruct"],
    ["sample", "--temperatures=a,b"],
    ["sample", "--temperatures=,"],
    ["eval", "--per_class"]])
def test_usage_errors_exit_2_as_in_jax(tmp_path, capsys, args):
    """Before any checkpoint is read (the workdir is empty), with the
    JAX CLI's message."""
    wd = [f"--workdir={tmp_path}"]
    assert jcli.main([*args, *wd]) == 2
    want = capsys.readouterr().err
    assert cli.main([*args, *wd, *CPU]) == 2
    assert capsys.readouterr().err == want
    with pytest.raises(SystemExit) as e:
        cli.main(["sample", "--interpolate", "--reconstruct", *wd, *CPU])
    assert e.value.code == 2


def _flag_value(dest, default):
    if default is False:
        return [f"--{dest}"]
    return [f"--{dest}={'x' if isinstance(default, str) else 2}"]


@pytest.mark.parametrize("dest", sorted(cli.LATER_FLAGS))
def test_refused_flags_name_their_item(tmp_path, capsys, dest):
    default, item = cli.LATER_FLAGS[dest]
    assert cli.main(["train", "--synthetic", f"--workdir={tmp_path}",
                     *_flag_value(dest, default), *CPU]) == 2
    err = capsys.readouterr().err
    assert f"--{dest}" in err and "ROADMAP queue 1 item" in err
    assert item in err
    assert not any(tmp_path.iterdir())      # refused before any work


@pytest.mark.parametrize("cmd,args", [
    ("distill", ["--steps", "4"]),
    ("serve-bench", ["-n", "8", "--fleet", "2"])])
def test_refused_subcommands_name_their_item(tmp_path, capsys, cmd, args):
    assert cli.main([cmd, f"--workdir={tmp_path}", *args]) == 2
    err = capsys.readouterr().err
    assert cmd in err and cli.LATER_COMMANDS[cmd] in err


def test_default_device_without_a_card_exits_2(port_workdir, capsys,
                                               monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in (["train", "--synthetic", "--no_resume"],
                ["eval", "--synthetic"], ["sample", "--synthetic"]):
        assert cli.main([*cmd, f"--workdir={port_workdir}"]) == 2
        assert "--device cpu" in capsys.readouterr().err
