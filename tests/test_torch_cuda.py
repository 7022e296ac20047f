"""The port's CUDA kernels on the card; every test skips without one.

These hold each kernel against its plain PyTorch version on the same
CUDA tensors at the test suite's tiny shapes (H=16, M=3: widths the
full-width run in ``chip_smoke.py`` does not reach), check that the
wrappers refuse what the kernels do not take, and serve a small burst on
the card against the same burst on the CPU. The card machine has no JAX,
so run them there without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sketch_rnn_tpu_torch import HParams
from sketch_rnn_tpu_torch.models.vae import SketchRNN
from sketch_rnn_tpu_torch.ops import cuda_decode as cd
from sketch_rnn_tpu_torch.serve.engine import Request, ServeEngine
from sketch_rnn_tpu_torch.utils import prng
from sketch_rnn_tpu_torch.utils.device import tree_to

pytestmark = pytest.mark.cuda

TINY = dict(batch_size=4, max_seq_len=32, enc_rnn_size=12,
            dec_rnn_size=16, z_size=6, num_mixture=3, serve_slots=4,
            serve_chunk=4)
B, K = 4, 4
# tiny widths: float32 rounding differs by ~1e-7 between the kernel's
# sums and the plain version's; 1e-5 is the JAX package's own budget
TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _model(cell, conditional, dev):
    hps = HParams(**TINY).replace(dec_model=cell, conditional=conditional)
    model = SketchRNN(hps)
    params = model.init_params(torch.Generator().manual_seed(0),
                               device=dev)
    return hps, model, params


def _decode_args(hps, model, params, dev):
    g = torch.Generator().manual_seed(1)
    z = (torch.randn((B, hps.z_size), generator=g).to(dev)
         if hps.conditional else None)
    c0, h0 = (x.contiguous() for x in
              model.decoder_initial_carry(params, z, B, device=dev))
    prev0 = torch.tensor([0, 0, 1.0, 0, 0]).repeat(B, 1).to(dev)
    keys = prng.fold_in(prng.key(4), torch.arange(B)).to(dev)
    t0 = torch.tensor([0, 3, 7, 20], dtype=torch.int32).to(dev)
    return (params["dec"], params["out_w"], params["out_b"], c0, h0, prev0,
            z, cd.make_uniforms(keys, t0, K),
            torch.tensor([0.5, 0.8, 1.0, 1.2]).to(dev), t0,
            torch.tensor([False, False, True, False]).to(dev),
            (t0 + torch.tensor([2, 9, 9, 9], dtype=torch.int32,
                               device=dev)),
            torch.tensor([0, 0, 0, 0, 1.0]).to(dev))


@pytest.mark.parametrize("cell,conditional,greedy", [
    ("lstm", False, False), ("lstm", True, False),
    ("layer_norm", False, False), ("layer_norm", True, False),
    ("layer_norm", True, True)])
def test_decode_kernel_matches_plain_version(dev, cell, conditional,
                                             greedy):
    hps, model, params = _model(cell, conditional, dev)
    args = _decode_args(hps, model, params, dev)
    kw = dict(cell_kind=cell, num_mixture=hps.num_mixture, greedy=greedy)
    before = cd.decode_chunk_launches
    got = cd.decode_chunk(*args, **kw)
    torch.cuda.synchronize()
    assert cd.decode_chunk_launches == before + 1
    *want, margin = cd.decode_chunk_reference(*args, **kw,
                                              return_margin=True)
    keep = (margin >= 1e-5).cpu()
    assert bool(keep.any())
    for a, b in zip(got, want):
        a, b = a.cpu(), b.cpu()
        if a.dim() == 3:
            a, b = a[:, keep], b[:, keep]
        else:
            a, b = a[keep], b[keep]
        if a.dtype in (torch.int32, torch.bool):
            assert torch.equal(a, b)
        else:
            assert float((a - b).abs().max()) <= TOL
    np.testing.assert_array_equal(got[0].cpu()[..., 2:].numpy(),
                                  want[0].cpu()[..., 2:].numpy())


@pytest.mark.parametrize("cell", ["lstm", "layer_norm"])
def test_replay_kernel_matches_plain_version(dev, cell):
    hps, model, params = _model(cell, True, dev)
    g = torch.Generator().manual_seed(2)
    z = torch.randn((B, hps.z_size), generator=g).to(dev)
    c0, h0 = (x.contiguous() for x in
              model.decoder_initial_carry(params, z, B))
    xs = torch.randn((6, B, 5), generator=g).to(dev)
    seq_len = torch.tensor([6, 2, 4, 1], dtype=torch.int32).to(dev)
    before = cd.replay_chunk_launches
    got = cd.replay_chunk(params["dec"], c0, h0, xs, z, seq_len,
                          cell_kind=cell)
    torch.cuda.synchronize()
    assert cd.replay_chunk_launches == before + 1
    want = cd.replay_chunk_reference(params["dec"], c0, h0, xs, z,
                                     seq_len, cell_kind=cell)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= TOL


def test_wrappers_refuse_bad_inputs(dev):
    hps, model, params = _model("lstm", False, dev)
    args = list(_decode_args(hps, model, params, dev))
    kw = dict(cell_kind="lstm", num_mixture=hps.num_mixture)
    before = cd.decode_chunk_launches
    bad = {3: args[3].t().contiguous().t(),      # non-contiguous c0
           8: args[8].double(),                  # float64 temps
           9: args[9].cpu(),                     # t0 on the CPU
           11: args[11].long()}                  # int64 caps
    for i, t in bad.items():
        a = list(args)
        a[i] = t
        with pytest.raises((ValueError, TypeError)):
            cd.decode_chunk(*a, **kw)
    assert cd.decode_chunk_launches == before


def test_engine_on_card_matches_cpu(dev):
    hps, model, params = _model("layer_norm", True, dev)
    rng = np.random.default_rng(0)
    z = rng.normal(size=(6, hps.z_size)).astype(np.float32)

    def burst(device, p):
        reqs = [Request(key=prng.fold_in(prng.key(8), i), z=z[i],
                        temperature=0.8, max_len=10) for i in range(6)]
        out = ServeEngine(model, hps, p, device=device).run(reqs)
        return {r.uid: r for r in out["results"]}

    card = burst(None, params)
    cpu = burst("cpu", tree_to(params, "cpu"))
    for uid, r in cpu.items():
        a = card[uid]
        assert a.steps == r.steps
        np.testing.assert_array_equal(a.strokes5[:, 2:], r.strokes5[:, 2:])
        assert float(np.abs(a.strokes5 - r.strokes5).max()) <= TOL
