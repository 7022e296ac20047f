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


FT, FB, FD = 7, 6, 5    # fused kernels: steps, rows, input width


def _fused_inputs(cell, h, dev, x_bias, mode):
    g = torch.Generator().manual_seed(h + 3 * x_bias)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g) * sc).to(dev)
    d = {"xs": r(FT, FB, FD), "wx": r(FD, 4 * h, sc=0.4),
         "wh": r(h, 4 * h, sc=0.25), "c0": r(FB, h, sc=0.3),
         "h0": r(FB, h, sc=0.3)}
    if cell == "lstm":
        d["b"] = r(4 * h, sc=0.1)
    else:
        d.update(ln_gamma=1 + r(4, h, sc=0.1), ln_beta=r(4, h, sc=0.1),
                 lnc_gamma=1 + r(h, sc=0.1), lnc_beta=r(h, sc=0.1),
                 x_bias=r(FB, 4 * h, sc=0.3) if x_bias else None)
    masks = seed = None
    if mode == "masks":
        masks = ((torch.rand((FT, FB, h), generator=g) < 0.9).float()
                 / 0.9).to(dev)
    elif mode == "seed":
        seed = torch.tensor(4242, dtype=torch.int32, device=dev)
    return d, masks, seed


def _run_fused(cell, d, masks, seed):
    """Forward + backward of one wrapper; returns (outputs, grads) with
    leaves cloned so the kernel and plain runs do not share grads."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    p = {k: (v.clone().requires_grad_(True) if v is not None else None)
         for k, v in d.items()}
    keep = 0.9 if seed is not None else 1.0
    if cell == "lstm":
        hs = cf.fused_lstm_seq(p["xs"], p["wx"], p["b"], p["wh"], p["c0"],
                               p["h0"], 1.0, masks, seed, keep)
        outs = (hs,)
        loss = (hs * torch.linspace(-1, 1, hs.numel(), device=hs.device)
                .view_as(hs)).sum()
        names = ("wx", "b", "wh")
    else:
        hs, (cT, hT) = cf.fused_ln_lstm(
            p["xs"], p["wx"], p["wh"], p["ln_gamma"], p["ln_beta"],
            p["lnc_gamma"], p["lnc_beta"], p["c0"], p["h0"], 1.0, masks,
            seed, keep, None, p["x_bias"])
        outs = (hs, cT, hT)
        loss = (hs * torch.linspace(-1, 1, hs.numel(), device=hs.device)
                .view_as(hs)).sum() + cT.sum() + 0.5 * hT.sum()
        names = ("xs", "wx", "wh", "ln_gamma", "ln_beta", "lnc_gamma",
                 "lnc_beta", "c0", "h0") + (
            ("x_bias",) if p["x_bias"] is not None else ())
    loss.backward()
    return outs, [p[n].grad for n in names]


@pytest.mark.parametrize("cell,h,x_bias,mode", [
    ("lstm", 16, False, "none"), ("lstm", 16, False, "seed"),
    ("lstm", 40, False, "masks"), ("layer_norm", 16, False, "none"),
    ("layer_norm", 16, True, "seed"), ("layer_norm", 40, True, "masks")])
def test_fused_kernels_match_plain_versions(dev, cell, h, x_bias, mode):
    """Each of the four training kernels against its plain version on the
    same CUDA tensors (forward values and every gradient), with and
    without dropout and x_bias; H=40 leaves part of the last warp idle."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    d, masks, seed = _fused_inputs(cell, h, dev, x_bias, mode)
    before = cf.launch_counts()
    outs, grads = _run_fused(cell, d, masks, seed)
    torch.cuda.synchronize()
    after = cf.launch_counts()
    key = "fused_lstm_seq" if cell == "lstm" else "fused_ln_lstm"
    assert after[key + "_fwd"] == before[key + "_fwd"] + 1
    assert after[key + "_bwd"] == before[key + "_bwd"] + 1
    cpu = {k: (v.cpu() if v is not None else None) for k, v in d.items()}
    want_outs, want_grads = _run_fused(
        cell, cpu, masks.cpu() if masks is not None else None,
        seed.cpu() if seed is not None else None)
    for a, b in zip(outs + tuple(grads), want_outs + tuple(want_grads)):
        a, b = a.detach().cpu(), b.detach()
        assert float((a - b).abs().max()) <= TOL * max(
            1.0, float(b.abs().max()))


def test_fused_prng_mask_bitwise_on_card(dev):
    """The kernel's in-kernel mask is prng_mask's: with wh = 0, wx = 0
    and b = 100 on the input gate, every h of the seq kernel is
    tanh(c) * sigmoid(b_o) with c = mask * tanh(b_g) * sigmoid(100)."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    h = 16
    b = torch.zeros(4 * h)
    b[:h] = 100.0              # i = 1
    b[h:2 * h] = 0.5           # g = tanh(0.5)
    b[2 * h:3 * h] = -1000.0   # f = 0 exactly (after the forget bias)
    args = [torch.zeros((3, FB, FD)), torch.zeros((FD, 4 * h)), b,
            torch.zeros((h, 4 * h)), torch.zeros((FB, h)),
            torch.zeros((FB, h))]
    seed = torch.tensor(99, dtype=torch.int32)
    got = cf.fused_lstm_seq(*(a.to(dev) for a in args), 1.0, None,
                            seed.to(dev), 0.9).cpu()
    for t in range(3):
        m = cf.prng_mask(seed, t, FB, h, 0.9)
        assert torch.equal(got[t] == 0, m == 0)


def test_fused_wrappers_refuse_bad_inputs(dev):
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    d, _, _ = _fused_inputs("layer_norm", 16, dev, True, "none")
    names = ("xs", "wx", "wh", "ln_gamma", "ln_beta", "lnc_gamma",
             "lnc_beta", "c0", "h0")
    before = cf.launch_counts()
    bad = {"xs": d["xs"].transpose(0, 1).contiguous().transpose(0, 1),
           "wh": d["wh"].double(), "c0": d["c0"].cpu(),
           "ln_gamma": d["ln_gamma"][:, :8].contiguous()}
    for n, t in bad.items():
        args = [t if m == n else d[m] for m in names]
        with pytest.raises((ValueError, TypeError)):
            cf.fused_ln_lstm(*args, x_bias=d["x_bias"])
    with pytest.raises(ValueError):
        cf.fused_ln_lstm(*(d[m] for m in names),
                         x_bias=d["x_bias"][:, :10].contiguous())
    big = torch.zeros((2, 2, 5), device=dev)
    with pytest.raises(ValueError, match="at most"):
        cf.fused_lstm_seq(big, torch.zeros((5, 2052), device=dev),
                          torch.zeros(2052, device=dev),
                          torch.zeros((513, 2052), device=dev),
                          torch.zeros((2, 513), device=dev),
                          torch.zeros((2, 513), device=dev))
    assert cf.launch_counts() == before


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
