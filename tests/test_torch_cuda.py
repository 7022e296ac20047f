"""The port's CUDA kernels on the card; every test skips without one.

These hold each kernel against its plain PyTorch version on the same
CUDA tensors at the test suite's tiny shapes (H=16/40, M=3: widths the
full-width run in ``chip_smoke.py`` does not reach), at float32 and at
bfloat16 weights and residuals, check that the wrappers refuse what the
kernels do not take, and serve a small burst on the card against the
same burst on the CPU. The card machine has no JAX, so run them there
without the JAX conftest:

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
# bfloat16: where the two float32 sums straddle a rounding boundary, a
# bfloat16 value (a stored hs, a rounded product operand, a weight
# gradient) moves by one ulp, 2**-8 relative
BF_TOL = 1e-2


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
    bf = torch.bfloat16
    bad = {3: args[3].t().contiguous().t(),      # non-contiguous c0
           8: args[8].double(),                  # float64 temps
           9: args[9].cpu(),                     # t0 on the CPU
           11: args[11].long(),                  # int64 caps
           1: args[1].to(bf)}                    # bf16 out_w, f32 compute
    for i, t in bad.items():
        a = list(args)
        a[i] = t
        with pytest.raises((ValueError, TypeError)):
            cd.decode_chunk(*a, **kw)
    # bfloat16 weights need the bfloat16 path, and float32 weights are
    # not taken by it: each raises, none falls back
    with pytest.raises(TypeError):
        cd.decode_chunk(cd.cast_weights(args[0], bf), *args[1:], **kw)
    with pytest.raises(TypeError):
        cd.decode_chunk(*args, **kw, compute_dtype=bf)
    assert cd.decode_chunk_launches == before


def _serve_case(cell, h, bsz, k, conditional, dev, wdt=torch.float32,
                seed=0):
    """Seeded decode_chunk arguments at width ``h`` and ``bsz`` slots: every
    third row hits its cap mid-chunk, every fifth starts done; plus the
    keyword arguments (``compute_dtype`` bfloat16 with bfloat16 weights
    where ``wdt`` is)."""
    hps = HParams(**TINY).replace(dec_model=cell, conditional=conditional,
                                  dec_rnn_size=h, serve_slots=bsz)
    model = SketchRNN(hps)
    params = model.init_params(torch.Generator().manual_seed(seed),
                               device=dev)
    g = torch.Generator().manual_seed(seed + 1)
    z = (torch.randn((bsz, hps.z_size), generator=g).to(dev)
         if conditional else None)
    c0, h0 = (x.contiguous() for x in
              model.decoder_initial_carry(params, z, bsz, device=dev))
    if not conditional:     # a nonzero carry all the same
        c0 = (0.3 * torch.randn((bsz, h), generator=g)).to(dev)
        h0 = (0.3 * torch.randn((bsz, h), generator=g)).to(dev)
    prev0 = torch.tensor([0, 0, 1.0, 0, 0]).repeat(bsz, 1).to(dev)
    keys = prng.fold_in(prng.key(seed + 4), torch.arange(bsz)).to(dev)
    t0 = torch.randint(0, 20, (bsz,), generator=g, dtype=torch.int32)
    rows = torch.arange(bsz)
    caps = torch.where(rows % 3 == 0,
                       t0 + torch.randint(1, max(2, k), (bsz,), generator=g,
                                          dtype=torch.int32), t0 + 100)
    dec, out_w, kw = params["dec"], params["out_w"], {}
    if wdt == torch.bfloat16:
        dec, out_w = cd.cast_weights(dec, wdt), out_w.to(wdt)
        kw["compute_dtype"] = wdt
    args = (dec, out_w, params["out_b"], c0, h0, prev0, z,
            cd.make_uniforms(keys, t0.to(dev), k),
            (0.4 + torch.rand((bsz,), generator=g)).to(dev), t0.to(dev),
            (rows % 5 == 2).to(dev), caps.to(dev),
            torch.tensor([0, 0, 0, 0, 1.0]).to(dev))
    return hps, args, dict(kw, cell_kind=cell, num_mixture=hps.num_mixture)


def _hold_decode(got, want, keep, tol, what):
    """t, done and pens exact on the kept rows, offsets and carries within
    ``tol`` of the larger of 1 and the reference's largest magnitude."""
    for name, a, b in zip(("strokes", "c", "h", "t", "done"), got, want):
        a, b = a.cpu(), b.cpu()
        a, b = (a[:, keep], b[:, keep]) if a.dim() == 3 else (a[keep],
                                                              b[keep])
        if name == "done":
            a, b = a != 0, b != 0
        if a.dtype in (torch.int32, torch.bool):
            assert torch.equal(a, b), (what, name)
            continue
        if name == "strokes":
            assert torch.equal(a[..., 2:], b[..., 2:]), (what, "pens")
        err = float((a - b).abs().max())
        assert err <= tol * max(1.0, float(b.abs().max())), (what, name, err)


# the persistent serving loop (csrc/decode.cu, "Design") against the
# row-block design it replaced and the plain version: H=16 one slice, H=40
# three uneven slices (staged element by element), H=64 four slices
@pytest.mark.parametrize("cell,h,conditional,greedy,wdt", [
    ("layer_norm", 16, True, False, torch.float32),
    ("layer_norm", 40, False, False, torch.float32),
    ("layer_norm", 64, True, False, torch.float32),
    ("layer_norm", 64, True, True, torch.float32),
    ("layer_norm", 64, True, False, torch.bfloat16),
    ("layer_norm", 40, True, True, torch.bfloat16),
    ("lstm", 16, False, False, torch.float32),
    ("lstm", 40, True, False, torch.float32),
    ("lstm", 64, False, True, torch.float32),
    ("lstm", 64, True, False, torch.bfloat16)])
def test_decode_loop_matches_row_block_design(dev, cell, h, conditional,
                                              greedy, wdt):
    bsz, k = 12, 6
    hps, args, kw = _serve_case(cell, h, bsz, k, conditional, dev, wdt)
    kw["greedy"] = greedy
    before = cd.decode_chunk_launches
    run, outs = cd.decode_chunk_entries(*args, **kw)
    snap = lambda: [o.clone() for o in outs]
    run("srt_decode_chunk")
    new = snap()
    run("srt_decode_chunk")
    again = snap()
    run("srt_decode_chunk_rowblock")
    old = snap()
    torch.cuda.synchronize()
    assert cd.decode_chunk_launches == before        # uncounted
    assert all(torch.equal(a, b) for a, b in zip(new, again))
    *plain, margin = cd.decode_chunk_reference(*args, **kw,
                                               return_margin=True)
    f32 = wdt == torch.float32
    keep = (margin >= (1e-5 if f32 else 1e-3)).cpu()
    assert bool(keep.any())
    tol = TOL if f32 else 1e-3
    _hold_decode(new, old, keep, tol, "vs the row-block design")
    _hold_decode(new, plain, keep, tol, "vs the plain version")
    # the wrapper launches the same loop, counted
    got = cd.decode_chunk(*args, **kw)
    assert cd.decode_chunk_launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got[:4], new[:4]))
    assert torch.equal(got[4], new[4] != 0)


@pytest.mark.parametrize("cell,h,wdt", [
    ("layer_norm", 40, torch.float32), ("layer_norm", 64, torch.bfloat16),
    ("lstm", 64, torch.float32), ("lstm", 40, torch.bfloat16)])
def test_replay_loop_matches_row_block_design(dev, cell, h, wdt):
    """Replay with seq_len from 1 to E (one row each) and a nonzero carry."""
    e = bsz = 9
    hps, args, kw = _serve_case(cell, h, bsz, 1, True, dev, wdt)
    kw.pop("num_mixture")
    g = torch.Generator().manual_seed(7)
    xs = torch.randn((e, bsz, 5), generator=g).to(dev)
    seq_len = (torch.randperm(bsz, generator=g) + 1).to(torch.int32).to(dev)
    rargs = (args[0], args[3], args[4], xs, args[6], seq_len)
    before = cd.replay_chunk_launches
    run, outs = cd.replay_chunk_entries(*rargs, **kw)
    snap = lambda: [o.clone() for o in outs]
    run("srt_replay_chunk")
    new = snap()
    run("srt_replay_chunk")
    again = snap()
    run("srt_replay_chunk_rowblock")
    old = snap()
    torch.cuda.synchronize()
    assert cd.replay_chunk_launches == before
    assert all(torch.equal(a, b) for a, b in zip(new, again))
    want = cd.replay_chunk_reference(*rargs, **kw)
    tol = TOL if wdt == torch.float32 else 1e-3
    for a, b, w in zip(new, old, want):
        for ref in (b, w):
            assert float((a - ref).abs().max()) <= tol * max(
                1.0, float(ref.abs().max()))
    got = cd.replay_chunk(*rargs, **kw)
    assert cd.replay_chunk_launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, new))


@pytest.mark.parametrize("what,bsz,wdt", [
    ("decode", 512, torch.float32), ("replay", 1024, torch.bfloat16)])
def test_serving_loops_run_in_row_windows(dev, what, bsz, wdt):
    """At the decoder's width a slot count whose tiles do not fit in one
    launch runs in windows of rows, within tolerance of the row-block
    design, identical run to run."""
    h, k = 512, 2
    hps, args, kw = _serve_case("layer_norm", h, bsz, k, True, dev, wdt)
    plan = cd.decode_plan(bsz, h, hps.num_mixture,
                          cd.weight_dtype(kw.get("compute_dtype")), what)
    assert plan.windows > 1
    if what == "decode":
        run, outs = cd.decode_chunk_entries(*args, **kw)
        entry = "srt_decode_chunk"
    else:
        kw.pop("num_mixture")
        xs = torch.randn((3, bsz, 5),
                         generator=torch.Generator().manual_seed(8)).to(dev)
        seq_len = torch.tensor([1, 2, 3], dtype=torch.int32).repeat(
            bsz // 3 + 1)[:bsz].to(dev)
        run, outs = cd.replay_chunk_entries(args[0], args[3], args[4], xs,
                                            args[6], seq_len, **kw)
        entry = "srt_replay_chunk"
    snap = lambda: [o.clone() for o in outs]
    run(entry)
    new = snap()
    run(entry)
    again = snap()
    run(entry + "_rowblock")
    old = snap()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(new, again))
    tol = TOL if wdt == torch.float32 else 1e-2
    if what == "decode":
        _hold_decode(new, old, torch.ones(bsz, dtype=torch.bool), 1e-4,
                     "windows")
    else:
        for a, b in zip(new, old):
            assert float((a - b).abs().max()) <= tol * max(
                1.0, float(b.abs().max()))


def test_serving_loops_refuse_a_plan_they_cannot_run(dev, monkeypatch):
    """A plan whose blocks cannot co-reside, one whose shared memory does
    not hold its tiles, one whose slices do not cover the units and one
    without windows are refused before any launch: the call raises,
    nothing runs in its place, no launch is counted."""
    bsz, h, k = 512, 64, 2
    hps, args, kw = _serve_case("layer_norm", h, bsz, k, True, dev)
    good = cd.decode_plan(bsz, h, hps.num_mixture)
    rgood = cd.decode_plan(bsz, h, 1, policy="replay")
    xs = torch.zeros((2, bsz, 5), device=dev)
    seq_len = torch.full((bsz,), 2, dtype=torch.int32, device=dev)
    before = (cd.decode_chunk_launches, cd.replay_chunk_launches)
    for fix in (dict(tiles=bsz), dict(smem=0), dict(slices=1),
                dict(windows=0)):
        for name, p in (("decode_chunk", good), ("replay_chunk", rgood)):
            bad = p._replace(**fix)
            if "tiles" in fix:   # shared memory that holds the tiles
                bad = bad._replace(smem=cd.decode_smem(
                    name.split("_")[0], 4, h, hps.num_mixture, p.slices, 1))
            monkeypatch.setattr(cd, "decode_plan", lambda *a, q=bad, **o: q)
            with pytest.raises(RuntimeError, match=name):
                if name == "decode_chunk":
                    cd.decode_chunk(*args, **kw)
                else:
                    cd.replay_chunk(args[0], args[3], args[4], xs, args[6],
                                    seq_len, cell_kind="layer_norm")
    torch.cuda.synchronize()
    assert (cd.decode_chunk_launches, cd.replay_chunk_launches) == before


FT, FB, FD = 7, 6, 5    # fused kernels: steps, rows, input width


def _fused_inputs(cell, h, dev, x_bias, mode, wdt=torch.float32, t=FT,
                  bsz=FB, dx=FD):
    g = torch.Generator().manual_seed(h + 3 * x_bias)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g) * sc).to(dev)
    d = {"xs": r(t, bsz, dx), "wx": r(dx, 4 * h, sc=0.4).to(wdt),
         "wh": r(h, 4 * h, sc=0.25).to(wdt), "c0": r(bsz, h, sc=0.3),
         "h0": r(bsz, h, sc=0.3)}
    if cell in ("lstm", "lstm_full"):
        d["b"] = r(4 * h, sc=0.1)
        d["x_bias"] = r(bsz, 4 * h, sc=0.3) if x_bias else None
    else:
        d.update(ln_gamma=1 + r(4, h, sc=0.1), ln_beta=r(4, h, sc=0.1),
                 lnc_gamma=1 + r(h, sc=0.1), lnc_beta=r(h, sc=0.1),
                 x_bias=r(bsz, 4 * h, sc=0.3) if x_bias else None)
    masks = seed = None
    if mode == "masks":
        masks = ((torch.rand((t, bsz, h), generator=g) < 0.9).float()
                 / 0.9).to(dev)
    elif mode == "seed":
        seed = torch.tensor(4242, dtype=torch.int32, device=dev)
    return d, masks, seed


def _run_fused(cell, d, masks, seed, rdt=None):
    """Forward + backward of one wrapper; returns (outputs, grads) with
    leaves cloned so the kernel and plain runs do not share grads.
    ``cell``: "lstm" (fused_lstm_seq), "lstm_full" (fused_lstm) or
    "layer_norm" (fused_ln_lstm); ``rdt``: the residual dtype."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    p = {k: (v.clone().requires_grad_(True) if v is not None else None)
         for k, v in d.items()}
    keep = 0.9 if seed is not None else 1.0

    def weighted(hs):
        return (hs.float() * torch.linspace(-1, 1, hs.numel(),
                                            device=hs.device)
                .view_as(hs)).sum()

    if cell == "lstm":
        hs = cf.fused_lstm_seq(p["xs"], p["wx"], p["b"], p["wh"], p["c0"],
                               p["h0"], 1.0, masks, seed, keep, rdt)
        outs = (hs,)
        loss = weighted(hs)
        names = ("wx", "b", "wh")
    else:
        if cell == "lstm_full":
            hs, (cT, hT) = cf.fused_lstm(
                p["xs"], p["wx"], p["b"], p["wh"], p["c0"], p["h0"], 1.0,
                masks, seed, keep, rdt, p["x_bias"])
            names = ("xs", "wx", "b", "wh", "c0", "h0")
        else:
            hs, (cT, hT) = cf.fused_ln_lstm(
                p["xs"], p["wx"], p["wh"], p["ln_gamma"], p["ln_beta"],
                p["lnc_gamma"], p["lnc_beta"], p["c0"], p["h0"], 1.0, masks,
                seed, keep, rdt, p["x_bias"])
            names = ("xs", "wx", "wh", "ln_gamma", "ln_beta", "lnc_gamma",
                     "lnc_beta", "c0", "h0")
        outs = (hs, cT, hT)
        loss = weighted(hs) + cT.sum() + 0.5 * hT.sum()
        names += ("x_bias",) if p["x_bias"] is not None else ()
    loss.backward()
    return outs, [p[n].grad for n in names]


_COUNTER = {"lstm": "fused_lstm_seq", "lstm_full": "fused_lstm",
            "layer_norm": "fused_ln_lstm"}


def _hold_fused(dev, cell, d, masks, seed, tol, rdt=None):
    """One kernel pair (forward + backward, one launch each) against its
    plain version on the same tensors, each output within ``tol`` of the
    plain one relative to max(1, its largest magnitude)."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    before = cf.launch_counts()
    outs, grads = _run_fused(cell, d, masks, seed, rdt)
    torch.cuda.synchronize()
    after = cf.launch_counts()
    key = _COUNTER[cell]
    assert after[key + "_fwd"] == before[key + "_fwd"] + 1
    assert after[key + "_bwd"] == before[key + "_bwd"] + 1
    cpu = {k: (v.cpu() if v is not None else None) for k, v in d.items()}
    want_outs, want_grads = _run_fused(
        cell, cpu, masks.cpu() if masks is not None else None,
        seed.cpu() if seed is not None else None, rdt)
    for a, b in zip(outs + tuple(grads), want_outs + tuple(want_grads)):
        assert a.dtype == b.dtype
        a, b = a.detach().cpu().float(), b.detach().float()
        assert float((a - b).abs().max()) <= tol * max(
            1.0, float(b.abs().max()))


def _cases(names, rows):
    """Parametrize cases; those at the default (T, B) keep their ids."""
    out = []
    for *vals, tb in rows:
        ident = "-".join(str(v).replace("torch.", "") for v in vals)
        if tb != (FT, FB):
            ident += f"-T{tb[0]}-B{tb[1]}"
        out.append(pytest.param(*vals, tb, id=ident))
    return pytest.mark.parametrize(names + ",tb", out)


# the LSTM backward's loop partitions the hidden units into slices of 16
# and the batch into tiles: H=136 (not a multiple of 32 nor of the slice
# count), B=1 and 3, T=1 leave slices, tiles and warp tasks uneven
@_cases("cell,h,x_bias,mode", [
    ("lstm", 16, False, "none", (FT, FB)),
    ("lstm", 16, False, "seed", (FT, FB)),
    ("lstm", 40, False, "masks", (FT, FB)),
    ("layer_norm", 16, False, "none", (FT, FB)),
    ("layer_norm", 16, True, "seed", (FT, FB)),
    ("layer_norm", 40, True, "masks", (FT, FB)),
    ("lstm_full", 16, False, "none", (FT, FB)),
    ("lstm_full", 16, True, "seed", (FT, FB)),
    ("lstm_full", 40, True, "masks", (FT, FB)),
    ("lstm", 136, False, "seed", (FT, FB)),
    ("lstm_full", 136, True, "seed", (FT, FB)),
    ("lstm", 16, False, "none", (1, 1)),
    ("lstm", 40, False, "seed", (FT, 3)),
    ("lstm_full", 40, True, "masks", (FT, 1)),
    ("lstm_full", 136, True, "masks", (1, 3))])
def test_fused_kernels_match_plain_versions(dev, cell, h, x_bias, mode, tb):
    """Each of the six training kernels against its plain version on the
    same CUDA tensors (forward values and every gradient), with and
    without dropout and x_bias; H=40 leaves part of the last warp idle.
    ``lstm_full`` takes nonzero dcT/dhT (its loss reads cT and hT)."""
    d, masks, seed = _fused_inputs(cell, h, dev, x_bias, mode, t=tb[0],
                                   bsz=tb[1])
    _hold_fused(dev, cell, d, masks, seed, TOL)


@_cases("cell,h,mode,wdt,rdt", [
    ("lstm", 16, "seed", torch.bfloat16, torch.bfloat16, (FT, FB)),
    ("lstm_full", 40, "masks", torch.bfloat16, torch.bfloat16, (FT, FB)),
    ("lstm_full", 16, "seed", torch.bfloat16, torch.float32, (FT, FB)),
    ("layer_norm", 16, "seed", torch.bfloat16, torch.bfloat16, (FT, FB)),
    ("layer_norm", 40, "none", torch.float32, torch.bfloat16, (FT, FB)),
    ("lstm_full", 136, "seed", torch.bfloat16, torch.bfloat16, (FT, 3)),
    ("lstm", 136, "masks", torch.bfloat16, torch.bfloat16, (1, 1)),
    ("lstm_full", 40, "seed", torch.bfloat16, torch.float32, (1, 3))])
def test_fused_kernels_bf16_match_plain_versions(dev, cell, h, mode, wdt,
                                                 rdt, tb):
    """The training kernels at bfloat16 weights and/or residuals (the
    flagship preset's setting) against their plain versions: outputs and
    gradients in the same dtypes, within a bfloat16 ulp's reach."""
    d, masks, seed = _fused_inputs(cell, h, dev, True, mode, wdt, t=tb[0],
                                   bsz=tb[1])
    _hold_fused(dev, cell, d, masks, seed, BF_TOL, rdt)


# the decoder's input under input dropout: the whole stream [x; z; class
# embedding] with no x_bias (the flagship's D=197, the vae preset's 133)
@pytest.mark.parametrize("cell,h,dx,wdt,rdt", [
    ("layer_norm", 16, 13, torch.float32, torch.float32),
    ("layer_norm", 40, 197, torch.bfloat16, torch.bfloat16),
    ("lstm_full", 16, 133, torch.float32, torch.float32),
    ("lstm_full", 40, 133, torch.bfloat16, torch.float32)])
def test_fused_kernels_at_dropout_input_widths_match_plain(dev, cell, h, dx,
                                                           wdt, rdt):
    d, masks, seed = _fused_inputs(cell, h, dev, False, "seed", wdt, dx=dx)
    tol = TOL if wdt == rdt == torch.float32 else BF_TOL
    _hold_fused(dev, cell, d, masks, seed, tol, rdt)


@pytest.mark.parametrize("h,t,bsz,wdt,rdt,full", [
    (16, FT, FB, torch.float32, torch.float32, True),
    (136, FT, 3, torch.float32, torch.float32, True),
    (40, 1, 1, torch.float32, torch.bfloat16, False),
    (136, FT, FB, torch.bfloat16, torch.bfloat16, True),
    (40, FT, 3, torch.bfloat16, torch.float32, False),
    (256, 9, 100, torch.bfloat16, torch.bfloat16, True)])
def test_lstm_bwd_matches_row_block_design(dev, h, t, bsz, wdt, rdt, full):
    """srt_lstm_bwd (hoisted recompute, cooperative loop, weight pass)
    against the row-block design it replaced, srt_lstm_bwd_rowblock, on
    the same inputs (dropout seeded, x_bias and carry cotangents when
    ``full``), within TOL / BF_TOL; two runs of the new entry bitwise
    equal. B=100 fills the card's SMs with the loop's tiles."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    d, _, seed = _fused_inputs("lstm_full", h, dev, full, "seed", wdt, t=t,
                               bsz=bsz)
    hs, cs, _, _ = cf.lstm_fwd(d["xs"], d["wx"], d["b"], d["wh"], d["c0"],
                               d["h0"], 1.0, None, seed, 0.9, d["x_bias"],
                               rdt)
    g = torch.Generator().manual_seed(5)
    dhs = (0.1 * torch.randn(hs.shape, generator=g)).to(dev).to(hs.dtype)
    cot = (0.1 * torch.randn((2, bsz, h), generator=g)).to(dev)
    kw = dict(dcT=cot[0] if full else None, dhT=cot[1] if full else None,
              dropout_seed=seed, keep_prob=0.9, x_bias=d["x_bias"],
              full=full)
    before = cf.launch_counts()
    run, outs = cf.lstm_bwd_entries(d["xs"], d["wx"], d["b"], d["wh"],
                                    d["h0"], hs, cs, dhs, **kw)
    snap = lambda: [o.clone() if o is not None else None for o in outs]
    run("srt_lstm_bwd")
    first = snap()
    run("srt_lstm_bwd")
    second = snap()
    run("srt_lstm_bwd_rowblock")
    old = snap()
    torch.cuda.synchronize()
    assert cf.launch_counts() == before
    tol = TOL if wdt == torch.float32 and rdt == torch.float32 else BF_TOL
    for a, b, c in zip(first, second, old):
        if a is None:
            assert b is None and c is None
            continue
        assert torch.equal(a, b)
        assert float((a - c).abs().max()) <= tol * max(
            1.0, float(c.abs().max()))


F32, BF16 = torch.float32, torch.bfloat16


# H=136 leaves uneven slices (15-16 units of 16); B=1 and 3 uneven tiles;
# B=4096 takes the tile's h rows in several chunks; D=11 passes the 8
# inputs the kernel holds in registers
@pytest.mark.parametrize("h,bsz,wdt,rdt,full,mode,dx", [
    (16, 1, F32, F32, True, "seed", FD),
    (16, 100, F32, BF16, False, "masks", FD),
    (136, 3, F32, F32, True, "masks", FD),
    (136, 100, BF16, BF16, False, "seed", FD),
    (136, 1, BF16, F32, True, "masks", FD),
    (256, 100, BF16, BF16, False, "seed", FD),
    (256, 3, F32, F32, False, "masks", FD),
    (256, 4096, BF16, BF16, False, "seed", FD),
    (256, 4096, F32, F32, True, "masks", FD),
    (512, 100, F32, F32, True, "seed", FD),
    (512, 100, BF16, BF16, True, "masks", FD),
    (512, 3, BF16, F32, False, "seed", FD),
    (40, 6, F32, F32, True, "seed", 11),
    (512, 100, BF16, BF16, True, "masks", 11)])
def test_lstm_fwd_matches_row_block_design(dev, h, bsz, wdt, rdt, full,
                                           mode, dx):
    """srt_lstm_fwd (the cooperative loop) against the row-block design it
    replaced, srt_lstm_fwd_rowblock, on the same inputs (x_bias and the
    final carry when ``full``, else the sequence-only form): every output
    bitwise equal, and two runs of the new entry bitwise equal."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    d, masks, seed = _fused_inputs("lstm_full", h, dev, full, mode, wdt,
                                   bsz=bsz, dx=dx)
    before = cf.launch_counts()
    run, outs = cf.lstm_fwd_entries(d["xs"], d["wx"], d["b"], d["wh"],
                                    d["c0"], d["h0"], 1.0, masks, seed, 0.9,
                                    d["x_bias"], rdt, full)
    snap = lambda: [o.clone() if o is not None else None for o in outs]
    run("srt_lstm_fwd")
    first = snap()
    run("srt_lstm_fwd")
    second = snap()
    run("srt_lstm_fwd_rowblock")
    old = snap()
    torch.cuda.synchronize()
    assert cf.launch_counts() == before
    assert (first[2] is None) == (not full)
    for a, b, c in zip(first, second, old):
        if a is None:
            assert b is None and c is None
            continue
        assert torch.equal(a, b)
        assert torch.equal(a, c)


def test_lstm_fwd_refuses_a_shape_it_cannot_hold(dev):
    """H=512 with D=400 inputs: the resident columns of wh and wx alone
    exceed a block's shared memory, however few rows a window takes. Both
    persistent forwards (the LSTM's and the LayerNorm-LSTM's) raise before
    any launch, count none, and nothing falls back to the row-block design
    (which holds the shape)."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    h, bsz, dx = 512, 4, 400
    z = lambda *s: torch.zeros(s, device=dev)
    before = cf.launch_counts()
    with pytest.raises(RuntimeError, match="CUDA error"):
        cf.lstm_seq_fwd(z(1, bsz, dx), z(dx, 4 * h), z(4 * h),
                        z(h, 4 * h), z(bsz, h), z(bsz, h))
    with pytest.raises(RuntimeError, match="CUDA error"):
        cf.ln_lstm_fwd(z(1, bsz, dx), z(dx, 4 * h), z(h, 4 * h), z(4, h),
                       z(4, h), z(h), z(h), z(bsz, h), z(bsz, h))
    assert cf.launch_counts() == before


# the LN forward's loop: H=16 one slice, H=40 three uneven ones (13, 13,
# 14 units), H=136 uneven slices of 15-16; B=1 and 3 fewer rows than tiles
# could take; B=4096 passes a tile's rows in several chunks (the pairs kept
# in the work scratch between a step's phases); D=11 passes the 8 inputs
# the kernel holds in registers; H=512, B=100 is the decoder's shape
@pytest.mark.parametrize("h,bsz,wdt,rdt,xb,mode,dx", [
    (16, 1, F32, F32, True, "seed", FD),
    (16, 100, F32, BF16, False, "masks", FD),
    (40, 3, F32, F32, True, "masks", FD),
    (40, 6, BF16, BF16, True, "none", 11),
    (136, 3, BF16, F32, True, "seed", FD),
    (136, 100, F32, F32, False, "seed", FD),
    (512, 100, F32, F32, True, "seed", FD),
    (512, 100, BF16, BF16, True, "masks", FD),
    (512, 3, BF16, F32, False, "seed", FD),
    (256, 4096, F32, BF16, False, "seed", FD),
    (512, 4096, BF16, BF16, True, "seed", FD),
    (512, 4096, F32, F32, True, "masks", FD)])
def test_ln_lstm_fwd_matches_row_block_design(dev, h, bsz, wdt, rdt, xb,
                                              mode, dx):
    """srt_ln_lstm_fwd (the cooperative loop, the layer norms' row moments
    exchanged between its blocks) against the row-block design it
    replaced, srt_ln_lstm_fwd_rowblock, and against the plain version on
    the same inputs, within TOL / BF_TOL (the row moments are summed in
    another order); two runs of the new entry bitwise equal; no launch
    counted."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    d, masks, seed = _fused_inputs("layer_norm", h, dev, xb, mode, wdt,
                                   bsz=bsz, dx=dx)
    ln = (d["ln_gamma"], d["ln_beta"], d["lnc_gamma"], d["lnc_beta"])
    args = (d["xs"], d["wx"], d["wh"], *ln, d["c0"], d["h0"], 1.0, masks,
            seed, 0.9 if seed is not None else 1.0, d["x_bias"], rdt)
    before = cf.launch_counts()
    run, outs = cf.ln_lstm_fwd_entries(*args)
    snap = lambda: [o.clone() for o in outs]
    run("srt_ln_lstm_fwd")
    first = snap()
    run("srt_ln_lstm_fwd")
    second = snap()
    run("srt_ln_lstm_fwd_rowblock")
    old = snap()
    torch.cuda.synchronize()
    assert cf.launch_counts() == before
    want = cf.ln_lstm_fwd_reference(*args)
    tol = TOL if wdt == F32 and rdt == F32 else BF_TOL
    for a, b, c, w in zip(first, second, old, want):
        assert a.dtype == c.dtype == w.dtype
        assert torch.equal(a, b)
        for ref in (c, w):
            assert float((a.float() - ref.float()).abs().max()) <= tol * max(
                1.0, float(ref.float().abs().max()))


def _entries_of(entry, h, bsz, wdt, dev, t):
    """The A/B helper's ``(run, outs)`` of one persistent entry on seeded
    inputs (x_bias, dropout seeded, residuals in the weight dtype; the
    backwards over the residuals of the matching forward wrapper and
    nonzero carry cotangents)."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    ln = entry.startswith("srt_ln_")
    d, _, seed = _fused_inputs("layer_norm" if ln else "lstm_full", h, dev,
                               True, "seed", wdt, t=t, bsz=bsz)
    lnp = ((d["ln_gamma"], d["ln_beta"], d["lnc_gamma"], d["lnc_beta"])
           if ln else ())
    w = (d["xs"], d["wx"], d["wh"], *lnp) if ln else (d["xs"], d["wx"],
                                                       d["b"], d["wh"])
    fwd = (*w, d["c0"], d["h0"], 1.0, None, seed, 0.9, d["x_bias"], wdt)
    if entry.endswith("_fwd"):
        return (cf.ln_lstm_fwd_entries(*fwd) if ln
                else cf.lstm_fwd_entries(*fwd, True))
    hs, cs, _, _ = (cf.ln_lstm_fwd if ln else cf.lstm_fwd)(*fwd)
    g = torch.Generator().manual_seed(5)
    dhs = (0.1 * torch.randn(hs.shape, generator=g)).to(dev).to(hs.dtype)
    cot = (0.1 * torch.randn((2, bsz, h), generator=g)).to(dev)
    kw = dict(dcT=cot[0], dhT=cot[1], dropout_seed=seed, keep_prob=0.9,
              x_bias=d["x_bias"])
    if ln:
        return cf.ln_lstm_bwd_entries(*w, d["h0"], hs, cs, dhs, **kw)
    return cf.lstm_bwd_entries(*w, d["h0"], hs, cs, dhs, **kw)


# at H=512, B=8192 a batch tile's state does not fit in one block's shared
# memory (the float wh rows of the LSTM backward's loop leave room for
# ~226 rows a tile, the forwards' resident columns for ~1,040), so each
# persistent entry runs as several cooperative launches over windows of
# rows; bench.py's encoder (H=256, B=4096, bf16) needs two for the LSTM
# backward
@pytest.mark.parametrize("entry,h,bsz,wdt", [
    ("srt_lstm_fwd", 512, 8192, F32), ("srt_lstm_bwd", 512, 8192, F32),
    ("srt_ln_lstm_fwd", 512, 8192, F32),
    ("srt_ln_lstm_bwd", 512, 8192, F32), ("srt_lstm_bwd", 256, 4096, BF16)])
def test_persistent_entries_run_in_row_windows(dev, entry, h, bsz, wdt):
    """Each persistent entry at a batch its tiles cannot hold at once (T=4)
    against its row-block entry on the same inputs: bitwise for
    srt_lstm_fwd (its sums keep the row-block order, whatever the
    windows), within TOL / BF_TOL for the others (the windows change the
    backwards' parts, the LN kernels sum their row moments in another
    order); two runs of the new entry bitwise equal; no launch counted."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    run, outs = _entries_of(entry, h, bsz, wdt, dev, 4)
    before = cf.launch_counts()
    snap = lambda: [o.clone() if o is not None else None for o in outs]
    run(entry)
    first = snap()
    run(entry)
    second = snap()
    run(entry + "_rowblock")
    old = snap()
    torch.cuda.synchronize()
    assert cf.launch_counts() == before
    tol = TOL if wdt == F32 else BF_TOL
    for a, b, c in zip(first, second, old):
        if a is None:
            assert b is None and c is None
            continue
        assert torch.equal(a, b)
        if entry == "srt_lstm_fwd":
            assert torch.equal(a, c)
        else:
            assert float((a.float() - c.float()).abs().max()) <= tol * max(
                1.0, float(c.float().abs().max()))


# the LN backward's loop: H=16 is one slice, H=40 three uneven ones (13,
# 13, 14 units); B=3 leaves fewer rows than tiles could take, B=100 and
# 200 more (the tiles fill the SMs); H=512, B=100 is the decoder's shape
@pytest.mark.parametrize("h,t,bsz,wdt,rdt,full,mode", [
    (16, FT, FB, F32, F32, True, "seed"),
    (16, FT, 200, F32, F32, False, "masks"),
    (16, FT, FB, BF16, F32, False, "none"),
    (40, FT, 3, F32, F32, True, "masks"),
    (40, FT, 100, BF16, BF16, True, "seed"),
    (40, 1, 1, F32, BF16, False, "seed"),
    (40, FT, 3, BF16, BF16, False, "masks"),
    (512, 5, 100, F32, F32, True, "masks"),
    (512, 9, 100, BF16, BF16, True, "seed")])
def test_ln_lstm_bwd_matches_row_block_design(dev, h, t, bsz, wdt, rdt, full,
                                              mode):
    """srt_ln_lstm_bwd (hoisted recompute and statistics, the cooperative
    loop, the weight pass) against the row-block design it replaced,
    srt_ln_lstm_bwd_rowblock, and against the plain version on the same
    inputs (x_bias and carry cotangents when ``full``), within TOL /
    BF_TOL; two runs of the new entry bitwise equal; no launch counted."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    d, masks, seed = _fused_inputs("layer_norm", h, dev, full, mode, wdt,
                                   t=t, bsz=bsz)
    ln = (d["ln_gamma"], d["ln_beta"], d["lnc_gamma"], d["lnc_beta"])
    keep = 0.9 if seed is not None else 1.0
    hs, cs, _, _ = cf.ln_lstm_fwd(d["xs"], d["wx"], d["wh"], *ln, d["c0"],
                                  d["h0"], 1.0, masks, seed, keep,
                                  d["x_bias"], rdt)
    g = torch.Generator().manual_seed(5)
    dhs = (0.1 * torch.randn(hs.shape, generator=g)).to(dev).to(hs.dtype)
    cot = (0.1 * torch.randn((2, bsz, h), generator=g)).to(dev)
    kw = dict(masks=masks, dropout_seed=seed, keep_prob=keep,
              x_bias=d["x_bias"])
    args = (d["xs"], d["wx"], d["wh"], *ln, d["h0"], hs, cs, dhs)
    before = cf.launch_counts()
    run, outs = cf.ln_lstm_bwd_entries(
        *args, dcT=cot[0] if full else None, dhT=cot[1] if full else None,
        **kw)
    snap = lambda: [o.clone() if o is not None else None for o in outs]
    run("srt_ln_lstm_bwd")
    first = snap()
    run("srt_ln_lstm_bwd")
    second = snap()
    run("srt_ln_lstm_bwd_rowblock")
    old = snap()
    torch.cuda.synchronize()
    assert cf.launch_counts() == before
    zero = torch.zeros((bsz, h), device=dev)
    want = cf.ln_lstm_bwd_reference(
        *args, cot[0] if full else zero, cot[1] if full else zero, **kw,
        f32_weight_grads=True)
    tol = TOL if wdt == torch.float32 and rdt == torch.float32 else BF_TOL
    assert (first[1] is None) == (not full)
    for a, b, c, w in zip(first, second, old, want):
        if a is None:
            assert b is None and c is None and w is None
            continue
        assert torch.equal(a, b)
        for ref in (c, w):
            assert float((a - ref).abs().max()) <= tol * max(
                1.0, float(ref.abs().max()))


@pytest.mark.parametrize("cell", ["lstm", "layer_norm"])
def test_bf16_serving_kernels_match_plain_versions(dev, cell):
    """decode_chunk and replay_chunk at compute_dtype=bfloat16, bfloat16
    weights (as the engine casts them), against their plain versions."""
    hps, model, params = _model(cell, True, dev)
    bf = torch.bfloat16
    args = list(_decode_args(hps, model, params, dev))
    args[0] = cd.cast_weights(args[0], bf)
    args[1] = args[1].to(bf)
    kw = dict(cell_kind=cell, num_mixture=hps.num_mixture,
              compute_dtype=bf)
    before = (cd.decode_chunk_launches, cd.replay_chunk_launches)
    got = cd.decode_chunk(*args, **kw)
    xs = torch.randn((6, B, 5), generator=torch.Generator().manual_seed(2)
                     ).to(dev)
    seq_len = torch.tensor([6, 2, 4, 1], dtype=torch.int32).to(dev)
    rkw = dict(cell_kind=cell, compute_dtype=bf)
    rgot = cd.replay_chunk(args[0], args[3], args[4], xs, args[6], seq_len,
                           **rkw)
    torch.cuda.synchronize()
    assert (cd.decode_chunk_launches, cd.replay_chunk_launches) == (
        before[0] + 1, before[1] + 1)
    *want, margin = cd.decode_chunk_reference(*args, **kw,
                                              return_margin=True)
    rwant = cd.replay_chunk_reference(args[0], args[3], args[4], xs,
                                      args[6], seq_len, **rkw)
    keep = (margin >= 1e-3).cpu()
    assert bool(keep.any())
    for a, b in zip(got, want):
        a, b = a.cpu(), b.cpu()
        a, b = (a[:, keep], b[:, keep]) if a.dim() == 3 else (a[keep],
                                                              b[keep])
        if a.dtype in (torch.int32, torch.bool):
            assert torch.equal(a, b)
        else:
            assert float((a - b).abs().max()) <= 1e-3
    for a, b in zip(rgot, rwant):
        assert float((a - b).abs().max()) <= 1e-3


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
    # float16 weights, weights of two dtypes, float16 residuals
    for wx, wh, rdt in ((d["wx"].half(), d["wh"].half(), None),
                        (d["wx"].to(torch.bfloat16), d["wh"], None),
                        (d["wx"], d["wh"], torch.float16)):
        args = [wx if m == "wx" else wh if m == "wh" else d[m]
                for m in names]
        with pytest.raises(TypeError):
            cf.fused_ln_lstm(*args, residual_dtype=rdt, x_bias=d["x_bias"])
    # a bfloat16 residual stream handed to the float32 backward
    hs = torch.zeros((FT, FB, 16), device=dev)
    with pytest.raises(TypeError):
        cf.ln_lstm_bwd(*(d[m] for m in names[:7]), d["h0"], hs,
                       hs.to(torch.bfloat16), hs, d["c0"], d["h0"])
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


# -- the HyperLSTM kernels ----------------------------------------------------


def _hyper_inputs(h, hh, e, dev, biases, mode, wdt=torch.float32, seed=0):
    """HyperLSTM weights, inputs, carries and dropout operands on ``dev``;
    every projection dense so every gradient is live."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    g = torch.Generator().manual_seed(seed)
    f = lambda *s, sc=1.0: (torch.randn(s, generator=g) * sc).to(dev)
    w = cf.HyperWeights(
        wx=f(FD, 4 * h, sc=0.4), b=f(4 * h, sc=0.1), wh=f(h, 4 * h, sc=0.25),
        wxh_x=f(FD, 4 * hh, sc=0.4), wxh_h=f(h, 4 * hh, sc=0.25),
        bh=f(4 * hh, sc=0.1), whh=f(hh, 4 * hh, sc=0.25),
        w_hz_x=f(hh, 4 * e, sc=0.2), b_hz_x=1 + f(4 * e, sc=0.1),
        w_hz_h=f(hh, 4 * e, sc=0.2), b_hz_h=1 + f(4 * e, sc=0.1),
        w_hz_b=f(hh, 4 * e, sc=0.2), zd_x=0.1 / e + f(4, e, h, sc=0.05),
        zd_h=0.1 / e + f(4, e, h, sc=0.05), zd_b=f(4, e, h, sc=0.05),
        ln_gamma=1 + f(4, h, sc=0.1), ln_beta=f(4, h, sc=0.1),
        lnc_gamma=1 + f(h, sc=0.1), lnc_beta=f(h, sc=0.1))
    w = w._replace(**{n: getattr(w, n).to(wdt) for n in cf.HYPER_MATRICES})
    d = {"xs": f(FT, FB, FD), "c0": f(FB, h, sc=0.3), "h0": f(FB, h, sc=0.3),
         "hc0": f(FB, hh, sc=0.3), "hh0": f(FB, hh, sc=0.3),
         "x_bias": f(FB, 4 * h, sc=0.3) if biases else None,
         "x_bias_hyper": f(FB, 4 * hh, sc=0.3) if biases else None,
         "w_out": f(FT, FB, h, sc=0.1)}
    masks = seed_t = None
    if mode == "masks":
        masks = ((torch.rand((FT, FB, h), generator=g) < 0.9).float()
                 / 0.9).to(dev)
    elif mode == "seed":
        seed_t = torch.tensor(4242, dtype=torch.int32, device=dev)
    return w, d, masks, seed_t


def _run_hyper(w, d, masks, seed, rdt=None):
    """Forward and every gradient through the autograd Function (the
    kernels on CUDA tensors, the plain versions on CPU tensors)."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    keep = 0.9 if seed is not None else 1.0
    leaves = {n: getattr(w, n).detach().float().requires_grad_(True)
              for n in cf.HyperWeights._fields}
    cast = lambda n: leaves[n].to(getattr(w, n).dtype)
    p = {k: v.detach().requires_grad_(True) for k, v in d.items()
         if v is not None and k != "w_out"}
    hs, ((cT, hT), (hcT, hhT)) = cf.fused_hyper_lstm(
        p["xs"], *(cast(n) for n in cf.HyperWeights._fields), p["c0"],
        p["h0"], p["hc0"], p["hh0"], 1.0, masks, seed, keep, rdt,
        p.get("x_bias"), p.get("x_bias_hyper"))
    outs = (hs, cT, hT, hcT, hhT)
    loss = (hs.float() * d["w_out"]).sum() + cT.sum() + 0.5 * hT.sum() \
        + 0.3 * hcT.sum() + 0.7 * hhT.sum()
    loss.backward()
    return outs, [x.grad for x in (*leaves.values(), *p.values())]


def _hold_hyper(w, d, masks, seed, tol, rdt=None):
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    before = cf.launch_counts()
    outs, grads = _run_hyper(w, d, masks, seed, rdt)
    again, grads2 = _run_hyper(w, d, masks, seed, rdt)
    torch.cuda.synchronize()
    after = cf.launch_counts()
    for k in ("fused_hyper_lstm_fwd", "fused_hyper_lstm_bwd"):
        assert after[k] == before[k] + 2
    for a, b in zip(outs + tuple(grads), again + tuple(grads2)):
        assert torch.equal(a, b)            # identical run to run
    cpu = lambda x: None if x is None else x.cpu()
    want_outs, want_grads = _run_hyper(
        cf.HyperWeights(*(x.cpu() for x in w)),
        {k: cpu(v) for k, v in d.items()}, cpu(masks), cpu(seed), rdt)
    for a, b in zip(outs + tuple(grads), want_outs + tuple(want_grads)):
        assert a.dtype == b.dtype
        a, b = a.detach().cpu().float(), b.detach().float()
        assert float((a - b).abs().max()) <= tol * max(
            1.0, float(b.abs().max()))


@pytest.mark.parametrize("h,hh,e,biases,mode", [
    (16, 32, 8, True, "seed"), (16, 32, 8, False, "none"),
    (40, 8, 4, True, "masks"), (40, 8, 4, False, "seed"),
    (24, 24, 3, True, "none")])
def test_hyper_kernels_match_plain_versions(dev, h, hh, e, biases, mode):
    """``fused_hyper_lstm`` forward and backward against their plain
    versions on the same tensors: hs, the four final carries and every
    gradient. H=16/HH=32 has the auxiliary LSTM (and 4e) wider than the
    main one, H=40/HH=8 leaves part of the last warp idle."""
    w, d, masks, seed = _hyper_inputs(h, hh, e, dev, biases, mode)
    _hold_hyper(w, d, masks, seed, TOL)


@pytest.mark.parametrize("h,hh,e,wdt,rdt", [
    (16, 32, 8, torch.bfloat16, torch.bfloat16),
    (40, 8, 4, torch.bfloat16, torch.float32),
    (40, 8, 4, torch.float32, torch.bfloat16)])
def test_hyper_kernels_bf16_match_plain_versions(dev, h, hh, e, wdt, rdt):
    w, d, masks, seed = _hyper_inputs(h, hh, e, dev, True, "seed", wdt)
    _hold_hyper(w, d, masks, seed, BF_TOL, rdt)


@pytest.mark.parametrize("h,hh,e,bsz,wdt,rdt,biases,mode", [
    (16, 32, 8, FB, F32, F32, True, "seed"),
    (16, 32, 8, 100, BF16, BF16, False, "masks"),
    (40, 8, 4, FB, F32, F32, False, "none"),
    (40, 8, 4, 100, BF16, F32, True, "seed"),
    (24, 24, 3, FB, F32, BF16, True, "masks")])
def test_hyper_bwd_matches_row_block_design(dev, h, hh, e, bsz, wdt, rdt,
                                            biases, mode):
    """srt_hyper_bwd (the hoisted recompute and statistics, the
    cooperative loop, dxs, the split-K products, the row sums) against the
    row-block design it replaced, srt_hyper_bwd_rowblock, and against the
    plain version on the same inputs, within TOL / BF_TOL; two runs of the
    new entry bitwise equal; no launch counted. H=16 under HH=32, H=40
    over HH=8, e=3 (12e not a multiple of 8)."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    w, d, masks, seed = _hyper_inputs(h, hh, e, dev, biases, mode, wdt)
    g = torch.Generator().manual_seed(7)
    r = lambda *s, sc=0.3: (sc * torch.randn(s, generator=g)).to(dev)
    xs = r(FT, bsz, FD, sc=1.0)
    if masks is not None:
        masks = ((torch.rand((FT, bsz, h), generator=g) < 0.9).float()
                 / 0.9).to(dev)
    keep = 0.9 if seed is not None else 1.0
    xb = (r(bsz, 4 * h), r(bsz, 4 * hh)) if biases else (None, None)
    drop = dict(masks=masks, dropout_seed=seed, keep_prob=keep,
                x_bias=xb[0], x_bias_hyper=xb[1])
    h0, hh0 = r(bsz, h), r(bsz, hh)
    hs, cs, hycs, hyhs = cf.hyper_lstm_fwd(
        xs, w, r(bsz, h), h0, r(bsz, hh), hh0, 1.0, **drop,
        residual_dtype=rdt)[:4]
    cot = dict(dhs=r(*hs.shape, sc=0.1).to(hs.dtype), dcT=r(bsz, h, sc=0.1),
               dhT=r(bsz, h, sc=0.1), dhcT=r(bsz, hh, sc=0.1),
               dhhT=r(bsz, hh, sc=0.1))
    args = dict(xs=xs, w=w, h0=h0, hh0=hh0, hs=hs, cs=cs, hycs=hycs,
                hyhs=hyhs, **cot, forget_bias=1.0, **drop)
    before = cf.launch_counts()
    run, outs = cf.hyper_lstm_bwd_entries(**args)
    snap = lambda: [o.clone() if o is not None else None for o in outs]
    run("srt_hyper_bwd")
    first = snap()
    run("srt_hyper_bwd")
    second = snap()
    run("srt_hyper_bwd_rowblock")
    old = snap()
    torch.cuda.synchronize()
    assert cf.launch_counts() == before
    dxs, dxb, dxbh, dw, dc0, dh0, dhc0, dhh0 = cf.hyper_lstm_bwd_reference(
        **args)
    # the matrices' float32 sums against the reference's, rounded to W
    want = [dxs, dxb, dxbh, *dw, dc0, dh0, dhc0, dhh0]
    tol = TOL if wdt == F32 and rdt == F32 else BF_TOL
    assert (first[1] is None) == (not biases)
    for a, b, c, ref in zip(first, second, old, want):
        if a is None:
            assert b is None and c is None and ref is None
            continue
        assert torch.equal(a, b)
        for o in (c, ref.float()):
            assert float((a - o).abs().max()) <= tol * max(
                1.0, float(o.abs().max()))


@pytest.mark.parametrize("h,hh,e,bsz,wdt,rdt,biases,mode", [
    (16, 32, 8, FB, F32, F32, True, "seed"),
    (16, 32, 8, 100, BF16, BF16, False, "masks"),
    (40, 8, 4, FB, F32, F32, False, "none"),
    (40, 8, 4, 100, BF16, F32, True, "seed"),
    (24, 24, 3, FB, F32, BF16, True, "masks"),
    (24, 24, 3, 1, F32, F32, True, "seed"),
    (18, 10, 3, FB, F32, F32, True, "seed"),     # k in part-filled quads
    # a tile's rows take several passes of the LayerNorm phases (their
    # pre-activations through the stash), at the preset's widths also of
    # the products
    (40, 8, 4, 2000, F32, F32, True, "seed"),
    (512, 256, 32, 520, F32, F32, True, "seed")])
def test_hyper_fwd_matches_row_block_design(dev, h, hh, e, bsz, wdt, rdt,
                                            biases, mode):
    """srt_hyper_fwd (the cooperative loop) against the row-block design
    it replaced, srt_hyper_fwd_rowblock, and against the plain version on
    the same inputs, within chip_smoke.py's FUSED_TOL (1e-4 at float32: at
    H=512 the layer norms' sums over 512 units in another order than the
    row-block's differ by 1.2e-5 after 7 steps; 1e-2 at bfloat16); two runs
    of the new entry bitwise equal; no launch counted. H=16 under HH=32,
    H=40 over HH=8, e=3 (12e not a multiple of 8), one row (slices of 8
    units, no split)."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    w, _, masks, seed = _hyper_inputs(h, hh, e, dev, biases, mode, wdt)
    g = torch.Generator().manual_seed(7)
    r = lambda *s, sc=0.3: (sc * torch.randn(s, generator=g)).to(dev)
    xs = r(FT, bsz, FD, sc=1.0)
    if masks is not None:
        masks = ((torch.rand((FT, bsz, h), generator=g) < 0.9).float()
                 / 0.9).to(dev)
    keep = 0.9 if seed is not None else 1.0
    xb = (r(bsz, 4 * h), r(bsz, 4 * hh)) if biases else (None, None)
    args = dict(xs=xs, w=w, c0=r(bsz, h), h0=r(bsz, h), hc0=r(bsz, hh),
                hh0=r(bsz, hh), forget_bias=1.0, masks=masks,
                dropout_seed=seed, keep_prob=keep, x_bias=xb[0],
                x_bias_hyper=xb[1], residual_dtype=rdt)
    if bsz >= 520:
        assert _ln_passes(cf.hyper_fwd_plan(bsz, FD, h, hh, e, wdt), bsz) > 1
    before = cf.launch_counts()
    run, outs = cf.hyper_lstm_fwd_entries(**args)
    snap = lambda: [o.clone() for o in outs]
    run("srt_hyper_fwd")
    first = snap()
    run("srt_hyper_fwd")
    second = snap()
    run("srt_hyper_fwd_rowblock")
    old = snap()
    torch.cuda.synchronize()
    assert cf.launch_counts() == before
    want = cf.hyper_lstm_fwd_reference(**args)
    tol = 1e-4 if wdt == F32 and rdt in (None, F32) else BF_TOL
    for a, b, c, ref in zip(first, second, old, want):
        assert a.dtype == c.dtype == ref.dtype
        assert torch.equal(a, b)
        for o in (c, ref):
            a32, o32 = a.float(), o.float()
            assert float((a32 - o32).abs().max()) <= tol * max(
                1.0, float(o32.abs().max()))


def _ln_passes(plan, bsz):
    """How many passes a LayerNorm tile's rows take under ``plan``."""
    rows = -(-bsz // plan.windows)
    nb = -(-rows // min(rows, plan.tiles))
    return -(-nb // plan.chunk)


def test_hyper_fwd_refuses_a_plan_it_cannot_run(dev, monkeypatch):
    """A plan whose blocks cannot co-reside (more blocks than the SMs
    hold), one whose shared memory does not hold its tiles, one whose
    slices do not cover the units and one whose LayerNorm pass is not
    whole warp tasks are refused before any launch: the call raises,
    nothing runs in its place, no launch is counted."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    w, d, _, seed = _hyper_inputs(16, 32, 8, dev, True, "seed")
    args = (d["xs"], w, d["c0"], d["h0"], d["hc0"], d["hh0"], 1.0, None,
            seed, 0.9, d["x_bias"], d["x_bias_hyper"])
    good = cf.hyper_fwd_plan(FB, FD, 16, 32, 8)
    before = cf.launch_counts()
    many = 64           # 64 slices x 4 tiles: more blocks than SMs
    for bad in (good._replace(slices=many, smem=cf.hyper_fwd_smem(
                    good.units, good.split, many, 2, FD, 16, 32, 8,
                    good.pchunk, good.chunk)),
                good._replace(smem=good.smem // 4),
                good._replace(slices=1),
                good._replace(chunk=3)):
        monkeypatch.setattr(cf, "hyper_fwd_plan", lambda *a, p=bad: p)
        with pytest.raises(RuntimeError, match="fused_hyper_lstm forward"):
            cf.hyper_lstm_fwd(*args)
    assert cf.launch_counts() == before


def test_hyper_bwd_refuses_a_plan_it_cannot_run(dev, monkeypatch):
    """A plan whose blocks cannot co-reside (more blocks than the SMs
    hold), one whose shared memory does not hold its tiles and one whose
    slices do not cover the units are refused before any launch: the
    call raises, nothing runs in its place, no launch is counted."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    w, d, _, seed = _hyper_inputs(16, 32, 8, dev, True, "seed")
    fwd = cf.hyper_lstm_fwd(d["xs"], w, d["c0"], d["h0"], d["hc0"],
                            d["hh0"], 1.0, None, seed, 0.9, d["x_bias"],
                            d["x_bias_hyper"])
    hs, cs, hycs, hyhs = fwd[:4]
    z, zh = torch.zeros_like(d["h0"]), torch.zeros_like(d["hh0"])
    args = (d["xs"], w, d["h0"], d["hh0"], hs, cs, hycs, hyhs,
            torch.zeros_like(hs), z, z, zh, zh, 1.0, None, seed, 0.9,
            d["x_bias"], d["x_bias_hyper"])
    good = cf.hyper_bwd_plan(FB, 16, 32, 8)
    before = cf.launch_counts()
    many = 200          # 200 slices x 6 tiles: more blocks than SMs
    for bad in (good._replace(slices=many, smem=cf.hyper_bwd_smem(
                    good.units, good.split, many, 1, 16, 32, 8, good.parts)),
                good._replace(smem=good.smem // 4),
                good._replace(slices=1, units=8)):
        monkeypatch.setattr(cf, "hyper_bwd_plan", lambda *a, p=bad: p)
        with pytest.raises(RuntimeError, match="fused_hyper_lstm backward"):
            cf.hyper_lstm_bwd(*args)
    assert cf.launch_counts() == before


def test_hyper_wrappers_refuse_bad_inputs(dev):
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    w, d, _, _ = _hyper_inputs(16, 32, 8, dev, True, "none")
    car = (d["c0"], d["h0"], d["hc0"], d["hh0"])
    before = cf.launch_counts()
    for bad in (w._replace(zd_x=w.zd_x.to(torch.bfloat16)),
                w._replace(whh=w.whh[:, :100].contiguous()),
                w._replace(b=w.b.cpu()),
                w._replace(w_hz_b=w.w_hz_b.t().contiguous().t())):
        with pytest.raises((ValueError, TypeError)):
            cf.hyper_lstm_fwd(d["xs"], bad, *car)
    with pytest.raises(ValueError, match="both x_bias"):
        cf.hyper_lstm_fwd(d["xs"], w, *car, x_bias=d["x_bias"])
    with pytest.raises(ValueError):
        cf.hyper_lstm_fwd(d["xs"], w, *car, x_bias=d["x_bias"],
                          x_bias_hyper=d["x_bias"])
    assert cf.launch_counts() == before


def test_hyper_engine_on_card_matches_cpu(dev):
    """The plain chunk program on the card against the same burst on the
    CPU; no decode kernel launches for the hyper cell."""
    hps, model, params = _model("hyper", True, dev)
    hps = hps.replace(hyper_rnn_size=8, hyper_embed_size=4)
    model = SketchRNN(hps)
    params = model.init_params(torch.Generator().manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    z = rng.normal(size=(6, hps.z_size)).astype(np.float32)

    def burst(device, p):
        reqs = [Request(key=prng.fold_in(prng.key(8), i), z=z[i],
                        temperature=0.8, max_len=10) for i in range(6)]
        out = ServeEngine(model, hps, p, device=device).run(reqs)
        assert out["metrics"]["decode_kernel"] == "plain"
        return {r.uid: r for r in out["results"]}

    before = cd.decode_chunk_launches
    card = burst(None, params)
    assert cd.decode_chunk_launches == before
    cpu = burst("cpu", tree_to(params, "cpu"))
    for uid, r in cpu.items():
        a = card[uid]
        assert a.steps == r.steps
        np.testing.assert_array_equal(a.strokes5[:, 2:], r.strokes5[:, 2:])
        assert float(np.abs(a.strokes5 - r.strokes5).max()) <= TOL


# -- lstm_seq (the cuDNN-layout LSTM) and the probe kernels -----------------


def _close(got, want, tol):
    """Each output within ``tol`` of the plain one relative to max(1, its
    largest magnitude), in the same dtype."""
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        assert float((a - b).abs().max()) <= tol * max(
            1.0, float(b.abs().max()))


@pytest.mark.parametrize("h,masks", [(16, True), (40, False), (40, True)])
def test_lstm_seq_kernels_match_plain_versions(dev, h, masks):
    """lstm_seq's forward (with its gate reserve) and backward against
    their plain versions on the same CUDA tensors, nonzero carries and
    cotangents; H=40 leaves part of the last warp idle; the backward,
    dwh included, the same bit for bit run to run; one launch per call;
    the autograd Function's gradients are the wrappers'."""
    from sketch_rnn_tpu_torch.ops import cuda_lstm as cl

    g = torch.Generator().manual_seed(h)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g) * sc).to(dev)
    xp, wh = r(FT, FB, 4 * h, sc=0.5), r(h, 4 * h, sc=0.25)
    c0, h0 = r(FB, h, sc=0.3), r(FB, h, sc=0.3)
    dhs, dcT, dhT = r(FT, FB, h, sc=0.1), r(FB, h, sc=0.1), r(FB, h, sc=0.1)
    m = ((torch.rand((FT, FB, h), generator=g) < 0.9).float() / 0.9).to(
        dev) if masks else None
    before = cl.launch_counts()
    out = cl.lstm_seq_fwd(xp, wh, c0, h0, 1.0, m)
    hs, _, _, gates, cs = out
    bargs = (wh, gates, cs, hs, h0, m, dhs, dcT, dhT)
    grads, again = cl.lstm_seq_bwd(*bargs), cl.lstm_seq_bwd(*bargs)
    torch.cuda.synchronize()
    after = cl.launch_counts()
    assert after["lstm_seq_fwd"] == before["lstm_seq_fwd"] + 1
    assert after["lstm_seq_bwd"] == before["lstm_seq_bwd"] + 2
    _close(out, cl.lstm_seq_fwd_plain(xp, wh, c0, h0, 1.0, m), TOL)
    h_prev = torch.cat([h0[None], hs[:-1]])
    _close(grads, cl.lstm_seq_bwd_plain(wh, gates, cs, h_prev, m, dhs, dcT,
                                        dhT), TOL)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    leaves = [x.clone().requires_grad_(True) for x in (xp, wh, c0, h0)]
    hs2, (cT2, hT2) = cl.lstm_seq(*leaves, 1.0, m)
    auto = torch.autograd.grad((hs2 * dhs).sum() + (cT2 * dcT).sum()
                               + (hT2 * dhT).sum(), leaves)
    assert all(torch.equal(a, b) for a, b in zip(auto, grads))


# lstm_seq's loops against its row-block design: H=16 is one slice, H=40
# three uneven ones, H=512 the decoder's width; T=1 one step; B=100 fills
# the SMs with tiles; at H=512, B=1000 the backward's loop runs in two
# windows of rows (a float32 launch holds ~904)
@pytest.mark.parametrize("h,t,bsz,masks", [
    (16, FT, FB, True), (40, 1, 3, False), (40, FT, 100, True),
    (512, 3, 100, False), (512, 2, 1000, True)])
def test_lstm_seq_matches_row_block_design(dev, h, t, bsz, masks):
    """srt_lstm_seq_fwd / srt_lstm_seq_bwd (the loops of
    csrc/lstm_loops.cuh) against srt_lstm_seq_*_rowblock through the A/B
    helpers, on nonzero carries and cotangents: the forward bit for bit,
    the backward within 1e-4 of the row-block entry and of the plain
    version, the same bits run to run and stage by stage (the loop, then
    the weight pass); no launch counted."""
    from sketch_rnn_tpu_torch.ops import cuda_lstm as cl

    g = torch.Generator().manual_seed(h + bsz)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g) * sc).to(dev)
    xp, wh = r(t, bsz, 4 * h, sc=0.5), r(h, 4 * h, sc=1.5 / h ** 0.5)
    c0, h0 = r(bsz, h, sc=0.3), r(bsz, h, sc=0.3)
    dhs, dcT, dhT = r(t, bsz, h, sc=0.1), r(bsz, h, sc=0.1), r(bsz, h,
                                                               sc=0.1)
    m = ((torch.rand((t, bsz, h), generator=g) < 0.9).float() / 0.9).to(
        dev) if masks else None
    before = cl.launch_counts()
    snap = lambda outs: [o.clone() for o in outs]
    run, outs = cl.lstm_seq_fwd_entries(xp, wh, c0, h0, 1.0, m)
    run("srt_lstm_seq_fwd")
    first = snap(outs)
    run("srt_lstm_seq_fwd")
    second = snap(outs)
    run("srt_lstm_seq_fwd_rowblock")
    old = snap(outs)
    hs, _, _, gates, cs = first
    brun, bouts = cl.lstm_seq_bwd_entries(wh, gates, cs, hs, h0, m, dhs, dcT,
                                          dhT)
    brun("srt_lstm_seq_bwd")
    bfirst = snap(bouts)
    brun("srt_lstm_seq_bwd")
    bsecond = snap(bouts)
    brun("srt_lstm_seq_bwd_stage", 1)
    brun("srt_lstm_seq_bwd_stage", 2)
    bstaged = snap(bouts)
    brun("srt_lstm_seq_bwd_rowblock")
    bold = snap(bouts)
    torch.cuda.synchronize()
    assert cl.launch_counts() == before
    for a, b, c in zip(first, second, old):
        assert torch.equal(a, b) and torch.equal(a, c)
    for a, b, c in zip(bfirst, bsecond, bstaged):
        assert torch.equal(a, b) and torch.equal(a, c)
    h_prev = torch.cat([h0[None], hs[:-1]])
    _close(bfirst, bold, 1e-4)
    _close(bfirst, cl.lstm_seq_bwd_plain(wh, gates, cs, h_prev, m, dhs, dcT,
                                         dhT), 1e-4)


def _probe_weights(h, dev, wdt):
    g = torch.Generator().manual_seed(h)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g) * sc).to(dev)
    xs = r(FT, FB, FD)
    return (xs, torch.flip(xs, dims=(0,)).contiguous(),
            r(FD, 4 * h, sc=0.4).to(wdt), r(4 * h, sc=0.1),
            r(h, 4 * h, sc=0.25).to(wdt), r(FD, 4 * h, sc=0.4).to(wdt),
            r(4 * h, sc=0.1), r(h, 4 * h, sc=0.25).to(wdt))


@pytest.mark.parametrize("h,wdt,rdt", [
    (16, torch.bfloat16, torch.bfloat16), (40, torch.bfloat16, torch.float32),
    (40, torch.float32, torch.bfloat16)])
def test_dual_seq_fwd_kernel_matches_plain_version(dev, h, wdt, rdt):
    """The dual-direction probe kernel against its plain version (two
    plain sequence forwards). At bfloat16 weights (the persistent loop)
    it equals two launches of seq_fwd's float32-gates arm (the same loop
    over one direction) bit for bit, its outputs rounded to bfloat16 as
    seq_fwd stores them; at float32 weights (the row-block design) two
    launches of the fused_lstm_seq forward kernel."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf
    from sketch_rnn_tpu_torch.scripts import probe_bf16_gates as pb
    from sketch_rnn_tpu_torch.scripts import probe_dual_encoder as pd

    args = _probe_weights(h, dev, wdt)
    before = pd.launch_counts()["dual_seq_fwd"]
    got = pd.dual_seq_fwd(*args, residual_dtype=rdt)
    torch.cuda.synchronize()
    assert pd.launch_counts()["dual_seq_fwd"] == before + 1
    _close(got, pd.dual_seq_fwd_plain(*args, residual_dtype=rdt),
           BF_TOL if torch.bfloat16 in (wdt, rdt) else TOL)
    if wdt == torch.bfloat16:
        pair = (*pb.seq_fwd(args[0], *args[2:5], False),
                *pb.seq_fwd(args[1], *args[5:], False))
        got = [g.to(torch.bfloat16) for g in got]
    else:
        z = torch.zeros((FB, h), device=dev)
        pair = (*cf.lstm_seq_fwd(args[0], *args[2:5], z, z,
                                 residual_dtype=rdt),
                *cf.lstm_seq_fwd(args[1], *args[5:], z, z,
                                 residual_dtype=rdt))
    assert all(torch.equal(a, b) for a, b in zip(got, pair))


@pytest.mark.parametrize("h,wdt", [(16, torch.bfloat16), (40, torch.float32),
                                   (40, torch.bfloat16)])
def test_seq_fwd_kernel_both_gate_arms(dev, h, wdt):
    """The bf16-gates probe kernel: the float32-gates arm within a
    bfloat16 ulp of its plain version and of the fused_lstm_seq forward
    kernel (bit for bit that kernel at float32 weights, where both run
    the row-block order of sums), the bfloat16-gates arm within the
    bfloat16 tolerance of its plain version."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf
    from sketch_rnn_tpu_torch.scripts import probe_bf16_gates as pb

    xs, _, wx, b, wh = _probe_weights(h, dev, wdt)[:5]
    z = torch.zeros((FB, h), device=dev)
    before = pb.launch_counts()["seq_fwd"]
    f32 = pb.seq_fwd(xs, wx, b, wh, False)
    bf = pb.seq_fwd(xs, wx, b, wh, True)
    torch.cuda.synchronize()
    assert pb.launch_counts()["seq_fwd"] == before + 2
    same = cf.lstm_seq_fwd(xs, wx, b, wh, z, z,
                           residual_dtype=torch.bfloat16)
    if wdt == torch.float32:
        assert all(torch.equal(a, c) for a, c in zip(f32, same))
    _close(f32, same, BF_TOL)
    _close(f32, pb.seq_fwd_plain(xs, wx, b, wh, False), BF_TOL)
    _close(bf, pb.seq_fwd_plain(xs, wx, b, wh, True), BF_TOL)


def test_lstm_seq_and_probe_wrappers_refuse_bad_inputs(dev):
    from sketch_rnn_tpu_torch.ops import cuda_lstm as cl
    from sketch_rnn_tpu_torch.scripts import probe_bf16_gates as pb
    from sketch_rnn_tpu_torch.scripts import probe_dual_encoder as pd

    h = 16
    xp, wh = torch.zeros((FT, FB, 4 * h), device=dev), torch.zeros(
        (h, 4 * h), device=dev)
    c = torch.zeros((FB, h), device=dev)
    counts = (cl.launch_counts(), pd.launch_counts(), pb.launch_counts())
    for bad in (dict(xp=xp.double()), dict(wh=wh[:, :8].contiguous()),
                dict(c0=c.cpu()), dict(h0=c.t().contiguous().t()),
                dict(masks=torch.zeros((FT, FB, h + 1), device=dev))):
        a = dict(dict(xp=xp, wh=wh, c0=c, h0=c), **bad)
        with pytest.raises((ValueError, TypeError)):
            cl.lstm_seq(a["xp"], a["wh"], a["c0"], a["h0"],
                        masks=a.get("masks"))
    with pytest.raises(ValueError, match="at most"):
        cl.lstm_seq_fwd(torch.zeros((2, 2, 4 * 513), device=dev),
                        torch.zeros((513, 4 * 513), device=dev),
                        torch.zeros((2, 513), device=dev),
                        torch.zeros((2, 513), device=dev))
    args = list(_probe_weights(h, dev, torch.bfloat16))
    for i, bad in ((2, args[2].half()), (4, args[4].float()),
                   (3, args[3][:8].contiguous())):
        with pytest.raises((ValueError, TypeError)):
            pd.dual_seq_fwd(*(bad if j == i else a
                              for j, a in enumerate(args)))
    with pytest.raises(TypeError):
        pd.dual_seq_fwd(*args, residual_dtype=torch.float16)
    with pytest.raises((ValueError, TypeError)):
        pb.seq_fwd(args[0], args[2], args[3], args[4].float(), True)
    assert (cl.launch_counts(), pd.launch_counts(),
            pb.launch_counts()) == counts


def _loop_inputs(h, bsz, dev, seed=0, d=FD):
    """The probe loop's operands at ``T = FT``, bfloat16 weights: ``wh``
    at ``N(0, 0.25 / H)``, a contracting recurrence, so that the one-ulp
    flip of a bfloat16 ``h`` where two float sums straddle a rounding
    boundary does not grow over the steps at any H."""
    g = torch.Generator().manual_seed(seed * 1000 + h)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g) * sc).to(dev)
    xs = r(FT, bsz, d)
    w = lambda: (r(d, 4 * h, sc=0.4).to(BF16), r(4 * h, sc=0.1),
                 r(h, 4 * h, sc=0.5 / h ** 0.5).to(BF16))
    return (xs, torch.flip(xs, dims=(0,)).contiguous(), *w(), *w())


# H = 8 and 24 pad k and the slice's units; B = 600 at H = 256 gives the
# dual's tiles 75 rows, two chunks of h (64 + 11); D = 9 takes the x
# inputs past the eight held in registers
@pytest.mark.parametrize("h,bsz,d", [(8, 6, FD), (24, 100, 9),
                                     (256, 600, FD)])
def test_probe_loop_matches_plain_versions(dev, h, bsz, d):
    """srt_dual_seq_fwd at both residual dtypes and srt_seq_fwd at both
    gate forms (the persistent tensor-core loop) against their plain
    versions; the dual bit for bit two single-direction launches; two
    runs identical; one launch counted per call."""
    from sketch_rnn_tpu_torch.scripts import probe_bf16_gates as pb
    from sketch_rnn_tpu_torch.scripts import probe_dual_encoder as pd

    args = _loop_inputs(h, bsz, dev, d=d)
    fwd, bwd = (args[0], *args[2:5]), (args[1], *args[5:])
    counts = (pd.launch_counts()["dual_seq_fwd"],
              pb.launch_counts()["seq_fwd"])
    for rdt in (F32, BF16):
        got = pd.dual_seq_fwd(*args, residual_dtype=rdt)
        again = pd.dual_seq_fwd(*args, residual_dtype=rdt)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        _close(got, pd.dual_seq_fwd_plain(*args, residual_dtype=rdt),
               BF_TOL)
    pair = (*pb.seq_fwd(*fwd, False), *pb.seq_fwd(*bwd, False))
    assert all(torch.equal(a, b) for a, b in zip(got, pair))
    for gates in (False, True):
        out = pb.seq_fwd(*fwd, gates)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b)
                   for a, b in zip(out, pb.seq_fwd(*fwd, gates)))
        _close(out, pb.seq_fwd_plain(*fwd, gates), BF_TOL)
    assert (pd.launch_counts()["dual_seq_fwd"],
            pb.launch_counts()["seq_fwd"]) == (counts[0] + 4,
                                               counts[1] + 6)


@pytest.mark.parametrize("h,bsz", [(24, 100), (256, 600)])
def test_probe_row_block_entries_match_plain_versions(dev, h, bsz):
    """The row-block entries kept for the A/B (srt_dual_seq_fwd_rowblock,
    srt_seq_fwd_rowblock) at bfloat16 weights against the plain versions
    and within the bfloat16 tolerance of the loop; no launch counted."""
    from sketch_rnn_tpu_torch.scripts import probe_bf16_gates as pb
    from sketch_rnn_tpu_torch.scripts import probe_dual_encoder as pd

    args = _loop_inputs(h, bsz, dev, seed=1)
    counts = (pd.launch_counts(), pb.launch_counts())
    cases = [(pd.dual_seq_fwd_entries(*args),
              pd.dual_seq_fwd_plain(*args))]
    cases += [(pb.seq_fwd_entries(args[0], *args[2:5], g),
               pb.seq_fwd_plain(args[0], *args[2:5], g))
              for g in (False, True)]
    for (run, outs), plain in cases:
        run("rowblock")
        old = [o.clone() for o in outs]
        run("loop")
        torch.cuda.synchronize()
        _close(old, plain, BF_TOL)
        _close(outs, old, BF_TOL)
    assert (pd.launch_counts(), pb.launch_counts()) == counts


def test_probe_loop_refuses_a_plan_it_cannot_run(dev, monkeypatch):
    """A plan whose blocks cannot co-reside (more tiles than the SMs
    hold) is refused by the cooperative launch's check, and one whose
    shared memory does not hold its tiles by the plan's check: the call
    raises, nothing runs in its place, no launch is counted."""
    from sketch_rnn_tpu_torch.scripts import _probe
    from sketch_rnn_tpu_torch.scripts import probe_bf16_gates as pb
    from sketch_rnn_tpu_torch.scripts import probe_dual_encoder as pd

    h, bsz = 256, 4096
    args = _loop_inputs(h, bsz, dev)
    good = _probe.probe_seq_plan(bsz, h, FD, 2)
    counts = (pd.launch_counts(), pb.launch_counts())
    for bad in (good._replace(tiles=good.tiles * 4),
                good._replace(smem=good.smem // 2)):
        monkeypatch.setattr(_probe, "device_plan", lambda *a, p=bad: p)
        with pytest.raises(RuntimeError, match="dual_seq_fwd"):
            pd.dual_seq_fwd(*args)
        with pytest.raises(RuntimeError, match="seq_fwd"):
            pb.seq_fwd(args[0], *args[2:5], False)
    assert (pd.launch_counts(), pb.launch_counts()) == counts


# -- the LayerNorm ladder (csrc/probe_ln.cu) ---------------------------------


def _ladder_inputs(h, dev, wdt, rdt, t=FT, bsz=FB):
    """The ladder's operands at tiny widths: weights of ``wdt``, LN
    parameters away from (1, 0), x_bias, nonzero carries and cotangents,
    dropout seeded at keep 0.9; the backward's residuals from the
    production forward kernel in ``rdt``."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    g = torch.Generator().manual_seed(h + 7)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g) * sc).to(dev)
    kw = dict(xs=r(t, bsz, FD), wx=r(FD, 4 * h, sc=0.4).to(wdt),
              wh=r(h, 4 * h, sc=0.25).to(wdt), ln_gamma=1 + r(4, h, sc=0.1),
              ln_beta=r(4, h, sc=0.1), lnc_gamma=1 + r(h, sc=0.1),
              lnc_beta=r(h, sc=0.1), x_bias=r(bsz, 4 * h, sc=0.3),
              dropout_seed=torch.tensor(5, dtype=torch.int32, device=dev),
              keep_prob=0.9)
    c0, h0 = r(bsz, h, sc=0.3), r(bsz, h, sc=0.3)
    hs, cs, _, _ = cf.ln_lstm_fwd(c0=c0, h0=h0, residual_dtype=rdt, **kw)
    bkw = dict(kw, h0=h0, hs=hs, cs=cs, dhs=r(t, bsz, h, sc=0.1).to(rdt),
               dcT=r(bsz, h, sc=0.1), dhT=r(bsz, h, sc=0.1))
    return dict(kw, c0=c0, h0=h0), bkw


def _ladder_arms(fkw, bkw, rdt, tol, stepwise=False):
    """Every forward and backward arm against its plain version (every arm
    the same bit for bit run to run), prod bit for bit the production
    entries srt_ln_lstm_fwd and srt_ln_lstm_bwd on the same inputs (the
    weight gradients as float32, unrounded). ``stepwise``: the forward's
    plain version takes each step from the kernel's stored carry
    (``fwd_plain(teacher=...)``, float32 residuals), as chip_smoke.py
    holds the ladder, instead of running free."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf
    from sketch_rnn_tpu_torch.scripts import probe_dec_bwd_split as ps
    from sketch_rnn_tpu_torch.scripts import probe_ln_stats as pl

    before = ps.launch_counts()
    for arm in ps.FWD_ARMS:
        got = ps.fwd_arm(arm, residual_dtype=rdt, **fkw)
        again = ps.fwd_arm(arm, residual_dtype=rdt, **fkw)
        torch.cuda.synchronize()
        _close(got, ps.fwd_plain(arm, residual_dtype=rdt,
                                 teacher=got[:2] if stepwise else None,
                                 **fkw), tol)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        if arm == "prod":
            production, want = cf.ln_lstm_fwd_entries(residual_dtype=rdt,
                                                      **fkw)
            production("srt_ln_lstm_fwd")
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    for arm in (*ps.ARMS, "fake"):
        run = pl.bwd_fake if arm == "fake" else (
            lambda a=arm, **k: ps.bwd_arm(a, **k))
        got, again = run(**bkw), run(**bkw)
        torch.cuda.synchronize()
        _close([g for g in got if g is not None],
               [p for p in ps.bwd_plain(arm, **bkw) if p is not None], tol)
        assert all(torch.equal(a, b) for a, b in zip(got, again)
                   if a is not None)
        if arm == "prod":
            production, want = cf.ln_lstm_bwd_entries(**bkw)
            production("srt_ln_lstm_bwd")
            assert all(torch.equal(a, b) for a, b in zip(got, want)
                       if a is not None)
    after = ps.launch_counts()
    assert all(after[f"fwd_{a}"] == before[f"fwd_{a}"] + 2
               for a in ps.FWD_ARMS)
    assert all(after[f"bwd_{a}"] == before[f"bwd_{a}"] + 2 for a in ps.ARMS)


@pytest.mark.parametrize("h,wdt,rdt", [
    (16, torch.bfloat16, torch.bfloat16), (40, torch.float32, torch.float32),
    (40, torch.bfloat16, torch.float32)])
def test_ln_ladder_kernels_match_plain_versions(dev, h, wdt, rdt):
    """Every forward and backward arm of csrc/probe_ln.cu (the persistent
    loops of csrc/ln_lstm.cuh) against its plain version, the same bit for
    bit run to run, and the prod arms bit for bit the production kernels
    they are, srt_ln_lstm_fwd and srt_ln_lstm_bwd."""
    fkw, bkw = _ladder_inputs(h, dev, wdt, rdt)
    _ladder_arms(fkw, bkw, rdt, BF_TOL if torch.bfloat16 in (wdt, rdt)
                 else TOL)


@pytest.mark.parametrize("h,wdt,rdt", [
    (16, torch.bfloat16, torch.bfloat16), (40, torch.float32, torch.float32),
    (40, torch.bfloat16, torch.float32)])
def test_ln_ladder_rowblock_entries_match_row_block_designs(dev, h, wdt,
                                                            rdt):
    """The row-block design the arms ran before, srt_ln_probe_*_rowblock:
    every arm against its plain version, and its prod arms bit for bit the
    row-block entries srt_ln_lstm_fwd_rowblock and srt_ln_lstm_bwd_rowblock
    (the weight gradients of both rounded as fused_ln_lstm rounds them);
    no launch counted."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf
    from sketch_rnn_tpu_torch.scripts import probe_dec_bwd_split as ps

    fkw, bkw = _ladder_inputs(h, dev, wdt, rdt)
    tol = BF_TOL if torch.bfloat16 in (wdt, rdt) else TOL
    before = ps.launch_counts()
    for arm in ps.FWD_ARMS:
        run, got = ps.fwd_entries(arm, residual_dtype=rdt, **fkw)
        run("srt_ln_probe_fwd_rowblock")
        torch.cuda.synchronize()
        _close(got, ps.fwd_plain(arm, residual_dtype=rdt, **fkw), tol)
        if arm == "prod":
            rowblock, want = cf.ln_lstm_fwd_entries(residual_dtype=rdt,
                                                    **fkw)
            rowblock("srt_ln_lstm_fwd_rowblock")
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    for arm in (*ps.ARMS, "fake"):
        run, got = ps.bwd_entries(arm, **bkw)
        run("srt_ln_probe_bwd_rowblock")
        torch.cuda.synchronize()
        _close([g for g in got if g is not None],
               [p for p in ps.bwd_plain(arm, **bkw) if p is not None], tol)
        if arm == "prod":
            rowblock, want = cf.ln_lstm_bwd_entries(**bkw)
            rowblock("srt_ln_lstm_bwd_rowblock")
            rnd = lambda o: (*o[:2], o[2].to(wdt), o[3].to(wdt), *o[4:])
            assert all(torch.equal(a, b)
                       for a, b in zip(rnd(got), rnd(want)))
    assert ps.launch_counts() == before


def test_ln_ladder_arms_run_in_row_windows(dev):
    """At H=512, B=8192 (T=8, float32) a batch tile's state does not fit
    in one block, so both loops run in two windows of rows: every arm
    against its plain version (the forward step by step: run free, the
    carry's float32 gap grows to ~1e-5 of hs by T=8 at this width), the
    same run to run, prod bit for bit the production entries over the
    same windows. Then prod over forced
    windows (the ladder's grid_scaling_ms): the forward bit for bit the
    same at 4 and 8 as at the planned 2 (its sums do not depend on the
    tiling), the backward at 4 within TOL of the planned run; one window,
    which does not fit, refused."""
    from sketch_rnn_tpu_torch.scripts import probe_dec_bwd_split as ps

    fkw, bkw = _ladder_inputs(512, dev, F32, F32, t=8, bsz=8192)
    _ladder_arms(fkw, bkw, F32, TOL, stepwise=True)
    fwd = [ps.fwd_arm("prod", residual_dtype=F32, windows=n, **fkw)
           for n in (0, 4, 8)]
    bwd = [ps.bwd_arm("prod", windows=n, **bkw) for n in (0, 4)]
    torch.cuda.synchronize()
    # one window of 8192 rows does not fit: refused before any launch
    with pytest.raises(RuntimeError, match="invalid argument"):
        ps.fwd_arm("prod", residual_dtype=F32, windows=1, **fkw)
    assert all(torch.equal(a, b) for f in fwd[1:] for a, b in zip(fwd[0], f))
    for other in bwd[1:]:
        _close(other, bwd[0], TOL)


def test_ln_ladder_wrappers_refuse_bad_inputs(dev):
    from sketch_rnn_tpu_torch.scripts import probe_dec_bwd_split as ps
    from sketch_rnn_tpu_torch.scripts import probe_ln_stats as pl

    fkw, bkw = _ladder_inputs(16, dev, torch.bfloat16, torch.bfloat16)
    counts = (ps.launch_counts(), pl.launch_counts())
    with pytest.raises(ValueError, match="arm"):
        ps.fwd_arm("no_lnbwd", **fkw)
    with pytest.raises(ValueError, match="arm"):
        ps.bwd_arm("fake", **bkw)
    for bad in (dict(wh=fkw["wh"].float()), dict(x_bias=fkw["x_bias"][:2]),
                dict(ln_gamma=fkw["ln_gamma"].cpu()),
                dict(dropout_seed=fkw["dropout_seed"].long())):
        with pytest.raises((ValueError, TypeError)):
            ps.fwd_arm("no_ln", **dict(fkw, **bad))
    for bad in (dict(hs=bkw["hs"].float()), dict(dcT=bkw["dcT"][:, :8]),
                dict(dhs=bkw["dhs"][:2])):
        with pytest.raises((ValueError, TypeError)):
            pl.bwd_fake(**dict(bkw, **bad))
    one = dict(fkw, wx=fkw["wx"][:, :4].contiguous(),
               wh=fkw["wh"][:1, :4].contiguous(),
               ln_gamma=fkw["ln_gamma"][:, :1].contiguous(),
               ln_beta=fkw["ln_beta"][:, :1].contiguous(),
               lnc_gamma=fkw["lnc_gamma"][:1], lnc_beta=fkw["lnc_beta"][:1],
               x_bias=fkw["x_bias"][:, :4].contiguous(),
               c0=fkw["c0"][:, :1].contiguous(),
               h0=fkw["h0"][:, :1].contiguous())
    with pytest.raises(ValueError, match="two columns"):
        ps.fwd_arm("no_ln", **one)
    assert (ps.launch_counts(), pl.launch_counts()) == counts


# The weight pass (csrc/weight_grad.cuh) over a seeded d_pre: R = D + H +
# ones and K = T * B off every tile (128) and k step (16, 32), D = 0 and
# ones 0 / 1, float and bfloat16 residuals; several slices in each.
@pytest.mark.parametrize("t,bsz,d,h,ones,wdt,rdt", [
    (37, 53, 3, 40, 1, F32, F32), (37, 53, 3, 40, 0, BF16, BF16),
    (37, 53, 0, 40, 0, F32, F32), (19, 101, 5, 136, 1, BF16, BF16),
    (19, 101, 5, 136, 0, F32, BF16), (41, 47, 0, 136, 1, BF16, F32),
    (29, 261, 133, 264, 1, BF16, BF16), (50, 100, 5, 256, 1, F32, F32)])
def test_weight_pass_matches_plain_version(dev, t, bsz, d, h, ones, wdt,
                                           rdt):
    """The split-K pass every backward entry runs (srt_weight_grad variant
    0) against weight_grad_reference on the same CUDA tensors, and against
    the pass it replaced (variant 1). Both sides round the same operands
    to the weight dtype and sum exact products in float32, so they part
    only by the order of the float32 sums: TOL relative to each output's
    largest magnitude at either dtype. Two runs bitwise equal; no launch
    counted."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    g = torch.Generator().manual_seed(t * h + d)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g) * sc).to(dev)
    xs, h0 = r(t, bsz, d), r(bsz, h, sc=0.3)
    hs = r(t, bsz, h, sc=0.3).to(rdt)
    d_pre = r(t, bsz, 4 * h, sc=0.01)
    assert cf.weight_grad_plan(t, bsz, d, h, ones, wdt).slices > 1
    before = cf.launch_counts()
    run, outs = cf.weight_grad_entries(xs, h0, hs, d_pre, ones, wdt)
    snap = lambda: [o.clone() for o in outs if o is not None]
    run(0)
    first = snap()
    run(0)
    second = snap()
    run(1)
    old = snap()
    torch.cuda.synchronize()
    assert cf.launch_counts() == before
    want = [w for w in cf.weight_grad_reference(xs, h0, hs, d_pre, d, h,
                                                ones, wdt) if w is not None]
    assert len(want) == len(first) == (3 if ones else 2)
    for a, b, c, w in zip(first, second, old, want):
        assert torch.equal(a, b)
        if not w.numel():           # dwx at D = 0
            assert a.shape == w.shape
            continue
        scale = max(float(w.abs().max()), 1e-30)
        assert float((a - w).abs().max()) <= TOL * scale
        assert float((a - c).abs().max()) <= TOL * scale


def test_weight_pass_refuses_a_plan_that_does_not_cover_k(dev, monkeypatch):
    """A plan whose slices miss part of K, or whose slice is not a whole
    number of k steps, is refused at launch: the call raises, and no
    other pass runs in its place."""
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf

    t, bsz, d, h = 9, 40, 5, 24
    xs, h0 = torch.zeros((t, bsz, d), device=dev), torch.zeros((bsz, h),
                                                               device=dev)
    hs, d_pre = torch.zeros((t, bsz, h), device=dev), torch.zeros(
        (t, bsz, 4 * h), device=dev)
    for bad in (cf.WeightGradPlan(2, 64), cf.WeightGradPlan(1, 360),
                cf.WeightGradPlan(20, 24)):
        monkeypatch.setattr(cf, "weight_grad_plan", lambda *a, p=bad: p)
        run, _ = cf.weight_grad_entries(xs, h0, hs, d_pre, 1, F32)
        with pytest.raises(RuntimeError, match="srt_weight_grad"):
            run(0)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_workdir_run_resumes_bitwise_on_the_card(dev, tmp_path, dt):
    """A small flagship-shaped run from ``.npz`` files with a workdir,
    evaluation and background saves, against the same run stopped at its
    step-2 save and resumed with fresh loaders: the final states equal
    bit for bit, and ``restore_checkpoint(device="cuda")`` of the last
    save equals the live state."""
    from sketch_rnn_tpu_torch.data.loader import (load_dataset,
                                                  write_synthetic_npz)
    from sketch_rnn_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                       restore_checkpoint)
    from sketch_rnn_tpu_torch.train.loop import train
    from sketch_rnn_tpu_torch.train.state import states_equal

    files = ("a.npz", "b.npz", "c.npz")
    for i, name in enumerate(files):
        write_synthetic_npz(str(tmp_path / name), num_train=12,
                            num_valid=5, num_test=4, class_id=i, seed=i,
                            max_len=28, integer_grid=255.0)
    hps = HParams(**TINY).replace(
        dec_model="layer_norm", conditional=True, num_classes=3,
        class_embed_size=4, fused_rnn=True, data_set=files, save_every=2,
        eval_every=2, log_every=1, compute_dtype=dt,
        fused_residual_dtype=dt)
    assert hps.async_checkpoint

    def run(sub, steps):
        tr, va, te, scale = load_dataset(hps, str(tmp_path))
        return train(hps, tr, va, te, scale, workdir=str(tmp_path / sub),
                     seed=1, num_steps=steps, device="cuda")

    whole = run("whole", 4)
    run("resumed", 2)
    resumed = run("resumed", 4)
    assert latest_checkpoint(str(tmp_path / "whole")) == 4
    assert states_equal(whole, resumed)
    restored, _, _ = restore_checkpoint(str(tmp_path / "whole"), whole,
                                        device="cuda")
    assert restored.params["out_b"].device.type == "cuda"
    assert states_equal(restored, whole)


def test_metrics_drain_reads_card_windows_through_pinned_copies(dev):
    """On the card a pushed window is stacked and copied into a pinned
    host buffer behind the step that made it; the drained rows hold the
    device values exactly, in push order."""
    from sketch_rnn_tpu_torch.train.metrics import MetricsDrain

    class Rows:
        rows = []

        def write(self, step, scalars):
            self.rows.append((step, scalars))

        def log_console(self, step, scalars):
            pass

    out = Rows()
    drain = MetricsDrain(out)
    want = []
    for step in range(1, 5):
        x = torch.randn(1 << 20, device=dev)
        m = {"loss": x.sum(), "kl": x.abs().max().to(torch.bfloat16)}
        want.append((step, {k: float(v.float()) for k, v in m.items()}))
        drain.push(step, m)
        assert len(out.rows) == step - 1
    drain.flush()
    assert out.rows == want


@pytest.mark.parametrize("over", [
    dict(dec_model="layer_norm", num_classes=3, class_embed_size=4),
    dict(dec_model="lstm"),
    dict(dec_model="hyper", hyper_rnn_size=8, hyper_embed_size=4),
    dict(dec_model="layer_norm", fused_rnn=False, remat=True),
    dict(dec_model="layer_norm", num_classes=3, class_embed_size=4,
         use_input_dropout=True, use_output_dropout=True),
    dict(dec_model="hyper", hyper_rnn_size=8, hyper_embed_size=4,
         use_input_dropout=True, use_output_dropout=True)])
def test_multi_step_graph_replay_is_its_eager_steps(dev, over):
    """``steps_per_call=2`` on the card: the first call runs its two steps
    eagerly and captures them; a later call is one graph replay, bit for
    bit two eager single steps with keys ``fold_in(key, i)`` from the
    same state (parameters, moments, counts and the window's metrics),
    with the launches of the two steps counted, and the caller's state
    left as it was."""
    from sketch_rnn_tpu_torch.data.loader import synthetic_loader
    from sketch_rnn_tpu_torch.ops import cuda_fused as CF
    from sketch_rnn_tpu_torch.train.loop import stack_batches
    from sketch_rnn_tpu_torch.train.state import (make_train_state,
                                                  states_equal, tree_items,
                                                  tree_map)
    from sketch_rnn_tpu_torch.train.step import (make_multi_train_step,
                                                 make_train_step,
                                                 replay_window_metrics)

    hps = HParams(**TINY).replace(**{**dict(
        conditional=True, fused_rnn=True, steps_per_call=2), **over})
    model = SketchRNN(hps)
    params = model.init_params(torch.Generator().manual_seed(0), device=dev)
    loader, _ = synthetic_loader(hps, num=32, seed=1)
    multi = make_multi_train_step(model, hps, device=dev)
    single = make_train_step(model, hps, device=dev)
    state, _ = multi(make_train_state(params), stack_batches(
        [loader.next_batch() for _ in range(2)]), prng.key(1))
    assert multi.graphed.captured == 1
    held = tree_map(torch.clone, state.params)
    batches, key = [loader.next_batch() for _ in range(2)], prng.key(2)
    CF.reset_launch_counts()
    got, met = multi(state, stack_batches(batches), key)
    torch.cuda.synchronize()
    replayed = CF.launch_counts()
    CF.reset_launch_counts()
    st, per = state, []
    for i, b in enumerate(batches):
        st, m = single(st, b, prng.fold_in(key, i))
        per.append(m)
    assert multi.graphed.captured == 1
    assert replayed == CF.launch_counts()
    assert (sum(replayed.values()) > 0) == hps.fused_rnn
    assert states_equal(got, st)
    want = replay_window_metrics(per)
    assert sorted(met) == sorted(want)
    for k in want:
        assert torch.equal(met[k], want[k]), k
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_items(held), tree_items(state.params)))


def test_feeder_at_depth_2_captures_and_matches_the_synchronous_feed(dev):
    """``data/prefetch.py`` on the card: at depth 2 the producer thread
    copies int16 batches to the card on its own stream while the K=2 step
    captures its graph at the first call; three calls end bit for bit on
    the state (and the last window's metrics) of the same calls fed
    float32 at depth 0 (an unaugmented integer-origin corpus, so int16 is
    exact), and so does ``train()`` at int16, depth 2, K=2, to step 5
    against ``train()`` at float32, depth 0."""
    from sketch_rnn_tpu_torch.data.loader import synthetic_loader
    from sketch_rnn_tpu_torch.data.prefetch import prefetch_batches
    from sketch_rnn_tpu_torch.train.loop import train
    from sketch_rnn_tpu_torch.train.state import (make_train_state,
                                                  states_equal)
    from sketch_rnn_tpu_torch.train.step import make_multi_train_step

    hps = HParams(**TINY).replace(
        conditional=True, fused_rnn=True, dec_model="layer_norm",
        num_classes=3, class_embed_size=4, steps_per_call=2)
    model = SketchRNN(hps)
    params = model.init_params(torch.Generator().manual_seed(0), device=dev)

    def loader():
        return synthetic_loader(hps, num=32, seed=1, integer_grid=255.0)[0]

    def run(dtype, depth):
        multi = make_multi_train_step(model, hps, device=dev)
        state = make_train_state(params)
        with prefetch_batches(loader(), dev, depth, stack=2,
                              transfer_dtype=dtype) as feeder:
            for i in range(3):
                batch = feeder.get()
                assert batch["strokes"].dtype == getattr(torch, dtype)
                assert all(v.device.type == "cuda" for v in batch.values())
                state, met = multi(state, batch,
                                   prng.fold_in(prng.key(1), i))
        assert multi.graphed.captured == 1
        return state, met

    (a, ma), (b, mb) = run("float32", 0), run("int16", 2)
    assert states_equal(a, b)
    assert sorted(ma) == sorted(mb)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)

    def run_train(dtype, depth):
        h = hps.replace(transfer_dtype=dtype, prefetch_depth=depth)
        rows = []
        state = train(h, loader(), seed=2, num_steps=5, params=params,
                      device=dev, history=rows)
        return state, rows

    (a, ra), (b, rb) = run_train("float32", 0), run_train("int16", 2)
    assert states_equal(a, b) and ra == rb


def test_bucketed_train_on_the_card_k3_is_k1(dev):
    """Length-bucketed ``train()`` on the card (edges 8, 16 under
    max_seq_len 32): K=3 through the bucket-run scheduler (a graph per
    full-stack geometry, run remainders through the single step) ends bit
    for bit on the K=1 run's state, with the same kernel launches, counted
    at the replays; each graph reports the memory its capture took."""
    from sketch_rnn_tpu_torch.data.loader import synthetic_loader
    from sketch_rnn_tpu_torch.ops import cuda_fused as cf
    from sketch_rnn_tpu_torch.train.loop import train
    from sketch_rnn_tpu_torch.train.state import (make_train_state,
                                                  states_equal)
    from sketch_rnn_tpu_torch.train.step import make_multi_train_step

    hps = HParams(**TINY).replace(
        conditional=True, fused_rnn=True, dec_model="layer_norm",
        num_classes=3, class_embed_size=4, bucket_edges=(8, 16),
        bucket_run_len=4, bucket_shuffle_window=4)
    model = SketchRNN(hps)
    params = model.init_params(torch.Generator().manual_seed(0), device=dev)

    def loader():
        return synthetic_loader(hps, num=40, seed=1)[0]

    runs = {}
    for k in (1, 3):
        cf.reset_launch_counts()
        runs[k] = (train(hps.replace(steps_per_call=k), loader(),
                         num_steps=14, params=params, device=dev),
                   cf.launch_counts())
    assert states_equal(runs[1][0], runs[3][0])
    assert runs[1][1] == runs[3][1]
    assert runs[1][1]["fused_ln_lstm_bwd"] == 14
    multi = make_multi_train_step(model, hps.replace(steps_per_call=3),
                                  device=dev, key_by_global_step=True)
    ld = loader()
    state = make_train_state(params)
    for _ in range(6):
        stack = ld.next_stack(3)
        if stack["strokes"].shape[0] == 3:
            state, _ = multi(state, stack, prng.key(0))
    graphs = multi.graphed
    assert graphs.captured >= 1
    assert len(graphs.capture_bytes) == graphs.captured
    assert all(b >= 0 for b in graphs.capture_bytes)


def _tenant_requests(hps):
    """Six requests, generate and complete, with caps 5..10."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(6):
        kw = dict(key=np.array([9, i], np.uint32), uid=i, max_len=5 + i,
                  temperature=0.6)
        if i % 2:
            p = np.zeros((4, 3), np.float32)
            p[:, :2] = rng.normal(size=(4, 2))
            kw.update(endpoint="complete", prefix=p)
        else:
            kw["z"] = rng.standard_normal(hps.z_size).astype(np.float32)
        out.append(Request(**kw))
    return out


@pytest.mark.parametrize("cell,dt", [("layer_norm", "bfloat16"),
                                     ("lstm", "float32")])
def test_congruent_swap_on_the_card_keeps_pointers_and_bits(dev, cell, dt):
    """A value-paged engine swapped between two tenants' trees keeps every
    weight tensor's data_ptr and its chunk program and serves each tree
    bitwise a fresh engine on it (decode and replay kernels, the
    encoder)."""
    from sketch_rnn_tpu_torch.serve.endpoints import serve_requests
    from sketch_rnn_tpu_torch.serve.tenants import TenantStore

    hps = HParams(**TINY).replace(dec_model=cell, conditional=True,
                                  compute_dtype=dt)
    model = SketchRNN(hps)
    base = model.init_params(torch.Generator().manual_seed(0), device=dev)
    store = TenantStore(base)
    rng = np.random.default_rng(5)
    store.register("t1", {k: v for k, v in base.items()} | {
        "out_w": (base["out_w"].cpu().numpy()
                  + 0.05 * rng.standard_normal(base["out_w"].shape)
                  ).astype(np.float32)})
    eng = ServeEngine(model, hps, base, param_args=True)
    serve_requests(model, hps, None, _tenant_requests(hps), engine=eng)
    ptrs = [t.data_ptr() for _, t in eng.weights]
    chunk_fn = eng._chunk_fn
    for t in ("t1", "", "t1"):
        tree = store.materialize(t)
        eng.swap_params(tree)
        got = serve_requests(model, hps, None, _tenant_requests(hps),
                             engine=eng)["results"]
        want = serve_requests(model, hps, tree,
                              _tenant_requests(hps))["results"]
        want = {r.uid: r.strokes5 for r in want}
        assert all(np.array_equal(r.strokes5, want[r.uid]) for r in got), t
    assert [t.data_ptr() for _, t in eng.weights] == ptrs
    assert eng._chunk_fn is chunk_fn


def test_cache_hit_on_the_card_is_its_recomputation(dev):
    """A fleet on the card with a result cache: a repeated request is a
    zero-step hit whose strokes are bitwise a fresh engine's."""
    from sketch_rnn_tpu_torch.serve.cache import ResultCache
    from sketch_rnn_tpu_torch.serve.fleet import ServeFleet

    hps, model, params = _model("layer_norm", True, dev)
    fleet = ServeFleet(model, hps, params, replicas=1, cache=ResultCache())
    reqs = _tenant_requests(hps)
    for r in reqs:
        fleet.submit(r)
    with fleet:
        assert fleet.drain(timeout=120)
        for r in _tenant_requests(hps):
            r.uid += 100
            fleet.submit(r)
        assert fleet.drain(timeout=60)
    res = fleet.results
    fresh = ServeEngine(model, hps, params)
    from sketch_rnn_tpu_torch.serve.endpoints import serve_requests
    want = {r.uid: r.strokes5 for r in serve_requests(
        model, hps, None, _tenant_requests(hps), engine=fresh)["results"]}
    for u, s5 in want.items():
        hit = res[u + 100]["result"]
        assert hit.cached and hit.attributed_steps == 0
        assert np.array_equal(hit.strokes5, s5)
        assert np.array_equal(res[u]["result"].strokes5, s5)
    assert fleet.summary()["cache"]["hits"] == len(want)
