"""The PyTorch port's package rules and interchange formats.

- The port imports neither JAX nor anything of ``sketch_rnn_tpu`` or of
  the root ``scripts/`` and ``bench.py``, nor flax or the ``msgpack``
  package (its checkpoints are written by ``utils/msgpack.py``): a
  subprocess importing every module of ``sketch_rnn_tpu_torch`` leaves
  them out of ``sys.modules``, and an AST scan of the package and of
  ``chip_smoke.py`` finds no such import.
- Entry points run on the card unless asked for the CPU: with no CUDA
  device and no ``device="cpu"`` they raise, and ``chip_smoke.py``
  exits non-zero with no result line.
- ``HParams`` JSON round-trips between the packages, and parameter trees
  carried across with ``convert.py`` come back bitwise.
"""

import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sketch_rnn_tpu.config import HParams as JHParams
from sketch_rnn_tpu.models.vae import SketchRNN as JSketchRNN
from sketch_rnn_tpu_torch import HParams
from sketch_rnn_tpu_torch.convert import params_from_jax, params_to_jax
from sketch_rnn_tpu_torch.models.vae import SketchRNN
from sketch_rnn_tpu_torch.serve.engine import ServeEngine

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "sketch_rnn_tpu_torch"
TINY = dict(batch_size=4, max_seq_len=32, enc_rnn_size=12,
            dec_rnn_size=16, z_size=6, num_mixture=3, serve_slots=4,
            serve_chunk=4)


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).replace(
            ".__init__", "")
        for p in PKG.rglob("*.py"))


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'sketch_rnn_tpu', 'flax', 'msgpack'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_or_reference_import(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib",
                                           "sketch_rnn_tpu", "scripts",
                                           "bench", "flax",
                                           "msgpack"), (path, n)


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hps = HParams(**TINY)
    model = SketchRNN(hps)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_params(torch.Generator().manual_seed(0))
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, hps, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"out_b": np.zeros(3, np.float32)})
    assert ServeEngine(model, hps, params, device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_a_card_or_the_package(tmp_path):
    """No CUDA device (or, on a card, no package beside the script):
    non-zero exit and no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env=dict(os.environ, PYTHONPATH=""))
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("over", [
    "", "conditional=true,dec_model=layer_norm",
    "dec_model=layer_norm,num_classes=75,serve_prefix_edges=16;64",
    "compute_dtype=bfloat16,fused_rnn=true,bucket_edges=64;128,"
    "mesh_shape=2;4,data_set=a.npz;b.npz,decode_kernel=pallas"])
def test_hparams_json_round_trips_between_packages(over):
    jh, th = JHParams().parse(over), HParams().parse(over)
    assert th.to_json() == jh.to_json()
    assert HParams.from_json(jh.to_json()) == th
    assert JHParams.from_json(th.to_json()) == jh
    assert [f.name for f in dataclasses.fields(HParams)] == \
        [f.name for f in dataclasses.fields(JHParams)]


def test_hparams_validation_matches():
    for bad in ("dec_model=gru", "serve_slots=0", "decode_kernel=fused",
                "serve_prefix_edges=64;32", "compute_dtype=float16"):
        for cls in (JHParams, HParams):
            with pytest.raises(ValueError):
                cls().parse(bad)


@pytest.mark.parametrize("over", [
    "conditional=false,dec_model=lstm",
    "conditional=true,dec_model=layer_norm",
    "conditional=true,dec_model=lstm,num_classes=3"])
def test_params_round_trip_bitwise(over):
    jh = JHParams(**TINY).parse(over)
    tree = jax.device_get(JSketchRNN(jh).init_params(jax.random.key(0)))
    back = params_to_jax(params_from_jax(tree, device="cpu"))
    flat_a, tdef_a = jax.tree_util.tree_flatten(tree)
    flat_b, tdef_b = jax.tree_util.tree_flatten(back)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    # the port's own init makes the same names and shapes
    own = SketchRNN(HParams(**TINY).parse(over)).init_params(
        torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree_util.tree_map(np.shape, params_to_jax(own)) == \
        jax.tree_util.tree_map(np.shape, tree)


def _c_prototypes(source):
    """``{name: [argument type, ...]}`` of the ``int srt_*(...)`` entries
    of one CUDA source, each argument as ``P`` (pointer), ``I`` (int) or
    ``F`` (float)."""
    import re

    text = (PKG / "csrc" / f"{source}.cu").read_text()
    out = {}
    for name, params in re.findall(r"^int (srt_\w+)\(([^)]*)\)", text,
                                   re.M):
        kinds = []
        for p in params.split(","):
            p = " ".join(p.split())
            kinds.append("P" if "*" in p else p.split()[-2][0].upper())
        out[name] = kinds
    return out


@pytest.mark.parametrize("source", ["decode", "fused_rnn", "lstm_seq",
                                    "probe_seq", "probe_ln", "fused_hyper"])
def test_ctypes_signatures_match_the_c_entries(source):
    """Every C entry of each CUDA source has its ctypes argtypes in
    ``ops/_build.py``, argument for argument (a pointer passed as a
    32-bit int would be cut)."""
    import ctypes

    from sketch_rnn_tpu_torch.ops import _build

    kind = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_float: "F"}
    protos = _c_prototypes(source)
    want = {n: [kind[a] for a in args]
            for n, args in _build.SIGNATURES[source].items()}
    assert protos == want
