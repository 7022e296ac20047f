"""The port's QuickDraw ndjson conversion against the JAX package's.

``sketch_rnn_tpu_torch/data/quickdraw.py`` and
``sketch_rnn_tpu_torch/scripts/convert_ndjson.py`` are held against
``sketch_rnn_tpu/data/quickdraw.py`` and ``scripts/convert_ndjson.py`` on
the same inputs: ndjson lines and drawings the tests write themselves
from seeded numpy draws (no QuickDraw file is read or fetched). Every
case of ``tests/test_quickdraw.py`` runs on the port and compares its
result with the JAX module's, bit for bit: ``rdp``,
``drawing_to_stroke3`` (with and without RDP, quantized, truncated),
``iter_ndjson`` with its one-line errors and ``skip_bad`` (and the
warning on stderr), ``stream_stroke3``, ``stream_categories``,
``stream_batches`` over a category stream (native and numpy), and
``convert_ndjson``'s ``.npz`` arrays. The data package exports the JAX
package's twelve names.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import sketch_rnn_tpu.data as jdata
from sketch_rnn_tpu.data import native_batcher as JNB
from sketch_rnn_tpu.data import quickdraw as jq
import sketch_rnn_tpu_torch.data as tdata
from sketch_rnn_tpu_torch.data import native_batcher as TNB
from sketch_rnn_tpu_torch.data import quickdraw as tq

ROOT = Path(__file__).resolve().parent.parent


def _write_ndjson(path, n, seed, word="cat", min_pts=4, max_pts=20,
                  strokes=1, scale=1.0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            drawing = []
            for _ in range(strokes):
                k = int(rng.integers(min_pts, max_pts))
                xs = (np.cumsum(rng.integers(-5, 6, k)) + 128) * scale
                ys = (np.cumsum(rng.integers(-5, 6, k)) + 128) * scale
                drawing.append([xs.tolist(), ys.tolist()])
            f.write(json.dumps({"word": word, "recognized": True,
                                "drawing": drawing}) + "\n")


def _same_arrays(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x, y)


def test_data_package_exports_the_jax_names():
    assert tdata.__all__ == jdata.__all__ and len(tdata.__all__) == 12
    for name in tdata.__all__:
        assert callable(getattr(tdata, name)), name


# -- rdp ------------------------------------------------------------------------


def test_rdp_drops_collinear_keeps_corners():
    xs = np.linspace(0, 10, 11)
    leg1 = np.stack([xs, np.zeros(11)], axis=1)
    leg2 = np.stack([np.full(10, 10.0), np.linspace(1, 10, 10)], axis=1)
    line = np.concatenate([leg1, leg2])
    out = tq.rdp(line, epsilon=0.5)
    np.testing.assert_array_equal(out, [[0, 0], [10, 0], [10, 10]])
    np.testing.assert_array_equal(out, jq.rdp(line, epsilon=0.5))


def test_rdp_epsilon_zero_is_identity():
    pts = np.array([[0, 0], [1, 0.4], [2, 0], [3, 0.4]])
    np.testing.assert_array_equal(tq.rdp(pts, 0.0), pts)
    np.testing.assert_array_equal(tq.rdp(pts, 0.0), jq.rdp(pts, 0.0))


def test_rdp_keeps_significant_deviation():
    pts = np.array([[0.0, 0], [5, 3], [10, 0]])
    np.testing.assert_array_equal(tq.rdp(pts, epsilon=1.0), pts)


def test_rdp_degenerate_closed_chord():
    pts = np.array([[0.0, 0], [5, 5], [0, 0]])
    out = tq.rdp(pts, epsilon=1.0)
    assert [5, 5] in out.tolist()
    np.testing.assert_array_equal(out, jq.rdp(pts, epsilon=1.0))


@pytest.mark.parametrize("eps", [0.5, 2.0, 7.0])
def test_rdp_random_polylines_match_jax(eps):
    rng = np.random.default_rng(int(eps * 10))
    for n in (3, 17, 120):
        pts = np.cumsum(rng.normal(0, 4, (n, 2)), axis=0)
        out = tq.rdp(pts, eps)
        np.testing.assert_array_equal(out, jq.rdp(pts, eps))
        np.testing.assert_array_equal(out[[0, -1]], pts[[0, -1]])


# -- drawing_to_stroke3 ------------------------------------------------------


def test_drawing_to_stroke3_deltas_and_pen():
    drawing = [[[0, 10, 10], [0, 0, 10]],
               [[20, 30], [20, 20]]]
    s3 = tq.drawing_to_stroke3(drawing, epsilon=0)
    assert s3.shape == (4, 3)
    np.testing.assert_array_equal(s3[:, 2], [0, 1, 0, 1])
    abs_pts = np.cumsum(s3[:, :2], axis=0)
    np.testing.assert_allclose(abs_pts[1], [10, 10])
    np.testing.assert_allclose(abs_pts[3], [30, 20])
    _same_arrays([s3], [jq.drawing_to_stroke3(drawing, epsilon=0)])


def test_drawing_to_stroke3_max_points_truncates_with_pen_end():
    drawing = [[list(range(50)), [0] * 50]]
    s3 = tq.drawing_to_stroke3(drawing, epsilon=0, max_points=10)
    assert len(s3) == 10 and s3[-1, 2] == 1.0
    _same_arrays([s3], [jq.drawing_to_stroke3(drawing, epsilon=0,
                                              max_points=10)])


def test_drawing_to_stroke3_resolution_independent():
    rng = np.random.default_rng(2)
    xs = np.cumsum(rng.integers(-9, 10, 40)).astype(float)
    ys = np.cumsum(rng.integers(-9, 10, 40)).astype(float)
    base = [[xs.tolist(), ys.tolist()]]
    scaled = [[(xs * 6.5).tolist(), (ys * 6.5).tolist()]]
    a = tq.drawing_to_stroke3(base, epsilon=2.0)
    b = tq.drawing_to_stroke3(scaled, epsilon=2.0)
    np.testing.assert_allclose(a, b, atol=1e-9)
    abs_pts = np.cumsum(a[:, :2], axis=0)
    assert float(np.ptp(abs_pts, axis=0).max()) <= 255.0 + 1e-6
    _same_arrays([a, b], [jq.drawing_to_stroke3(base, epsilon=2.0),
                          jq.drawing_to_stroke3(scaled, epsilon=2.0)])


def test_quantize_exact_integer_deltas_no_drift():
    rng = np.random.default_rng(3)
    n = 200
    xs = np.cumsum(rng.random(n) * 3.7)
    ys = np.cumsum(rng.random(n) * 2.3)
    drawing = [[xs.tolist(), ys.tolist()]]
    s3 = tq.drawing_to_stroke3(drawing, epsilon=0, quantize=True)
    np.testing.assert_array_equal(s3[:, :2], np.round(s3[:, :2]))
    recon = np.cumsum(s3[:, :2], axis=0)
    want = np.stack([np.round(xs), np.round(ys)], axis=1)
    np.testing.assert_allclose(recon + want[0], want[1:] if len(recon) ==
                               n - 1 else want, atol=0)
    _same_arrays([s3], [jq.drawing_to_stroke3(drawing, epsilon=0,
                                              quantize=True)])


@pytest.mark.parametrize("eps,quantize,max_points",
                         [(2.0, True, 250), (2.0, False, None),
                          (0.0, True, 24), (0.5, False, 8)])
def test_random_drawings_match_jax(eps, quantize, max_points):
    """Many-stroke drawings at a raw capture's scale, empty strokes among
    them: the port's stroke-3 arrays are the JAX module's bit for bit."""
    rng = np.random.default_rng(11)
    got, want = [], []
    for _ in range(25):
        drawing = []
        for _ in range(int(rng.integers(1, 5))):
            k = int(rng.integers(0, 30))
            drawing.append([(np.cumsum(rng.normal(0, 20, k)) + 500).tolist(),
                            (np.cumsum(rng.normal(0, 20, k)) + 400).tolist()])
        kw = dict(epsilon=eps, quantize=quantize, max_points=max_points)
        got.append(tq.drawing_to_stroke3(drawing, **kw))
        want.append(jq.drawing_to_stroke3(drawing, **kw))
    _same_arrays(got, want)


# -- iter_ndjson and the streams ---------------------------------------------


def test_iter_ndjson_filters_unrecognized():
    lines = [
        json.dumps({"word": "cat", "recognized": True,
                    "drawing": [[[0, 1], [0, 1]]]}),
        json.dumps({"word": "cat", "recognized": False,
                    "drawing": [[[0, 1], [0, 1]]]}),
        "",
    ]
    got = list(tq.iter_ndjson(lines))
    assert len(got) == 1 and got[0][0] == "cat"
    assert got == list(jq.iter_ndjson(lines))
    assert list(tq.iter_ndjson(lines, recognized_only=False)) == list(
        jq.iter_ndjson(lines, recognized_only=False))


@pytest.mark.parametrize("bad", ["{torn json", json.dumps({"word": "x"}),
                                 json.dumps([1, 2])])
def test_iter_ndjson_one_line_errors_and_skip_bad(bad, capfd):
    """A torn line, a record without a drawing and a record that is not
    an object each fail with the JAX module's one line; ``skip_bad``
    skips them with the same one warning line on stderr."""
    good = json.dumps({"word": "cat", "drawing": [[[0, 1], [0, 1]]]})
    lines = [good, bad, good]
    errors = []
    for mod in (tq, jq):
        with pytest.raises(ValueError) as e:
            list(mod.iter_ndjson(lines, source="f.ndjson"))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert errors[0].startswith("corrupt ndjson record: f.ndjson line 2: ")
    capfd.readouterr()
    got = list(tq.iter_ndjson(lines, source="f.ndjson", skip_bad=True))
    t_err = capfd.readouterr().err
    want = list(jq.iter_ndjson(lines, source="f.ndjson", skip_bad=True))
    j_err = capfd.readouterr().err
    assert got == want and len(got) == 2
    assert t_err == j_err == ("[data] WARNING: skipped 1 corrupt ndjson "
                              "line(s) in f.ndjson (skip_bad)\n")


def test_stream_stroke3_matches_converter_pipeline(tmp_path):
    path = tmp_path / "cat.ndjson"
    _write_ndjson(path, 20, seed=0)
    streamed = list(tq.stream_stroke3(str(path), epsilon=0.5,
                                      max_points=32))
    _same_arrays(streamed, list(jq.stream_stroke3(str(path), epsilon=0.5,
                                                  max_points=32)))
    for s in streamed:
        assert s.dtype == np.float32 and s.shape[1] == 3
        np.testing.assert_array_equal(s[:, :2], np.round(s[:, :2]))
    tq.convert_ndjson(str(path), str(tmp_path / "cat.npz"), epsilon=0.5,
                      max_points=32, num_valid=5, num_test=5, seed=3)
    with np.load(tmp_path / "cat.npz", allow_pickle=True,
                 encoding="latin1") as npz:
        pooled = sorted(a.tobytes() for split in ("train", "valid", "test")
                        for a in npz[split])
    assert sorted(s.astype(np.int16).tobytes() for s in streamed) == pooled
    assert len(list(tq.stream_stroke3(str(path), epsilon=0.5,
                                      max_points=32, limit=4))) == 4


def test_stream_stroke3_corrupt_lines(tmp_path):
    path = tmp_path / "bad.ndjson"
    _write_ndjson(path, 3, seed=1)
    with open(path, "a") as f:
        f.write("{torn json\n")
    with pytest.raises(ValueError, match="corrupt ndjson"):
        list(tq.stream_stroke3(str(path)))
    got = list(tq.stream_stroke3(str(path), skip_bad=True))
    assert len(got) == 3
    _same_arrays(got, list(jq.stream_stroke3(str(path), skip_bad=True)))


def test_stream_categories_interleaves_with_file_order_labels(tmp_path):
    _write_ndjson(tmp_path / "cat.ndjson", 4, seed=2, word="cat")
    _write_ndjson(tmp_path / "dog.ndjson", 6, seed=3, word="dog")
    for interleave in (True, False):
        pairs = list(tq.stream_categories(str(tmp_path), ["cat", "dog"],
                                          interleave=interleave))
        want = list(jq.stream_categories(str(tmp_path), ["cat", "dog.ndjson"],
                                         interleave=interleave))
        assert [lb for lb, _ in pairs] == [lb for lb, _ in want]
        _same_arrays([s for _, s in pairs], [s for _, s in want])
        labels = [lb for lb, _ in pairs]
        if interleave:
            assert labels == [0, 1] * 4 + [1, 1]
        else:
            assert labels == [0] * 4 + [1] * 6


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_stream_batches_feeds_loader_layout(tmp_path, path, monkeypatch):
    """ndjson stream -> the port's ``stream_batches`` -> loader-layout
    batches, bit for bit the JAX package's, natively and on the numpy
    path; over-length sequences dropped, ``drop_last`` honoured."""
    if path == "numpy":
        monkeypatch.setenv(TNB.NO_NATIVE_ENV, "1")
    _write_ndjson(tmp_path / "cat.ndjson", 5, seed=4, word="cat")
    _write_ndjson(tmp_path / "dog.ndjson", 5, seed=5, word="dog")
    pairs = list(tq.stream_categories(str(tmp_path), ["cat", "dog"],
                                      max_points=32))
    TNB.reset_call_counts()
    got = list(TNB.stream_batches(iter(pairs), batch_size=4, max_len=32))
    want = list(JNB.stream_batches(iter(pairs), batch_size=4, max_len=32))
    counts = TNB.call_counts()
    used = "assemble_batch" if path == "native" else "pad_batch_numpy"
    assert counts[used] == 3 and sum(counts.values()) == 3
    assert [len(b["seq_len"]) for b in got] == [4, 4, 2]
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(a["strokes"][:, 0, :],
                                      [[0, 0, 1, 0, 0]] * len(a["seq_len"]))
    long = np.zeros((40, 3), np.float32)
    seqs = [s for _, s in pairs[:4]]
    out = list(TNB.stream_batches(iter([long, np.zeros((0, 3))] + seqs),
                                  batch_size=4, max_len=32))
    assert [len(b["seq_len"]) for b in out] == [4]
    assert [len(b["seq_len"]) for b in TNB.stream_batches(
        iter(pairs), batch_size=4, max_len=32, drop_last=True)] == [4, 4]
    with pytest.raises(ValueError, match="must be >= 1"):
        next(TNB.stream_batches(iter(pairs), batch_size=0, max_len=32))


# -- convert_ndjson ------------------------------------------------------------


def _npz(path):
    with np.load(path, allow_pickle=True, encoding="latin1") as f:
        return {k: f[k] for k in ("train", "valid", "test")}


def _same_npz(a, b):
    for split in ("train", "valid", "test"):
        assert a[split].ndim == b[split].ndim == 1
        assert a[split].dtype == b[split].dtype == object
        _same_arrays(list(a[split]), list(b[split]))


def test_convert_ndjson_roundtrips_into_loader(tmp_path):
    path = tmp_path / "cat.ndjson"
    _write_ndjson(path, 30, seed=0)
    sizes = tq.convert_ndjson(str(path), str(tmp_path / "cat.npz"),
                              epsilon=0.5, num_valid=5, num_test=5)
    assert sizes == {"train": 20, "valid": 5, "test": 5}
    jdir = tmp_path / "jax"
    jdir.mkdir()
    assert jq.convert_ndjson(str(path), str(jdir / "cat.npz"), epsilon=0.5,
                             num_valid=5, num_test=5) == sizes
    _same_npz(_npz(tmp_path / "cat.npz"), _npz(jdir / "cat.npz"))

    from sketch_rnn_tpu_torch import HParams
    from sketch_rnn_tpu_torch.data.loader import load_dataset
    hps = HParams(batch_size=4, max_seq_len=32)
    train_l, valid_l, test_l, scale = load_dataset(hps,
                                                   data_dir=str(tmp_path))
    assert len(train_l) > 0 and scale > 0
    assert train_l.random_batch()["strokes"].shape == (4, 33, 5)


def test_convert_ndjson_too_small_raises(tmp_path):
    path = tmp_path / "cat.ndjson"
    with open(path, "w") as f:
        f.write(json.dumps({"word": "cat", "recognized": True,
                            "drawing": [[[0, 1, 2], [0, 1, 2]]]}) + "\n")
    errors = []
    for mod in (tq, jq):
        with pytest.raises(ValueError, match="usable drawings") as e:
            mod.convert_ndjson(str(path), str(tmp_path / "cat.npz"),
                               num_valid=5, num_test=5)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_convert_npz_is_1d_object_array_even_when_uniform(tmp_path):
    path = tmp_path / "u.ndjson"
    rng = np.random.default_rng(4)
    with open(path, "w") as f:
        for _ in range(12):
            xs = (np.cumsum(rng.integers(-5, 6, 30)) + 128).tolist()
            ys = (np.cumsum(rng.integers(-5, 6, 30)) + 128).tolist()
            f.write(json.dumps({"word": "u", "recognized": True,
                                "drawing": [[xs, ys]]}) + "\n")
    tq.convert_ndjson(str(path), str(tmp_path / "u.npz"), epsilon=0,
                      max_points=8, num_valid=3, num_test=3)
    jq.convert_ndjson(str(path), str(tmp_path / "j.npz"), epsilon=0,
                      max_points=8, num_valid=3, num_test=3)
    got = _npz(tmp_path / "u.npz")
    for split in ("train", "valid", "test"):
        arr = got[split]
        assert all(a.dtype == np.int16 and a.shape[1] == 3 for a in arr)
    _same_npz(got, _npz(tmp_path / "j.npz"))


def _jax_script():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_convert_ndjson", ROOT / "scripts" / "convert_ndjson.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_convert_script_matches_jax_script(tmp_path, capsys):
    """The port's ``scripts/convert_ndjson.py`` with the JAX script's
    flags writes the JAX script's files and lines; a torn line fails its
    file only (exit 1) unless ``--skip_bad_records``. It also runs as
    ``python -m sketch_rnn_tpu_torch.scripts.convert_ndjson``."""
    from sketch_rnn_tpu_torch.scripts import convert_ndjson as tscript

    jscript = _jax_script()
    for i, name in enumerate(("cat", "dog")):
        _write_ndjson(tmp_path / f"{name}.ndjson", 40, seed=i, strokes=2,
                      scale=3.0)
    dog = (tmp_path / "dog.ndjson").read_text()
    (tmp_path / "dog.ndjson").write_text("{torn\n" + dog)
    files = [str(tmp_path / "cat.ndjson"), str(tmp_path / "dog.ndjson")]
    flags = ["--num_valid", "4", "--num_test", "6", "--max_points", "24",
             "--limit", "35"]
    for extra in ([], ["--skip_bad_records"]):
        runs = []
        for who, mod in (("torch", tscript), ("jax", jscript)):
            out = tmp_path / f"{who}{len(extra)}"
            rc = mod.main(files + flags + extra + ["--out", str(out)])
            cap = capsys.readouterr()
            runs.append((rc, cap.out.replace(str(out), "OUT"),
                         cap.err.replace(str(out), "OUT"), out))
        (trc, tout, terr, tdir), (jrc, jout, jerr, jdir) = runs
        assert trc == jrc == (0 if extra else 1)
        assert (tout, terr) == (jout, jerr)
        names = sorted(os.listdir(tdir))
        assert names == sorted(os.listdir(jdir)) == (
            ["cat.npz", "dog.npz"] if extra else ["cat.npz"])
        for name in names:
            _same_npz(_npz(tdir / name), _npz(jdir / name))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    p = subprocess.run([sys.executable, "-m",
                        "sketch_rnn_tpu_torch.scripts.convert_ndjson",
                        files[0], "--out", str(tmp_path / "m")] + flags,
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    _same_npz(_npz(tmp_path / "m" / "cat.npz"),
              _npz(tmp_path / "jax1" / "cat.npz"))
