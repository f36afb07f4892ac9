"""The port's native batch gather (``vgd_tpu_torch/data/native.py``) and
the input staging built on it (``data/celeba.py`` ``Loader``,
``utils/prefetch.py``, ``train/loop.py`` ``_Staging``) against the JAX
package's native gather and loader and against numpy, on the CPU (the
host compiler builds both libraries here)."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from vgd_tpu.data import celeba as JDATA
from vgd_tpu.data import native as JN
from vgd_tpu_torch.data import celeba as PDATA
from vgd_tpu_torch.data import native as PN
from vgd_tpu_torch.parallel.mesh import LOCAL, Mesh
from vgd_tpu_torch.train import loop as L
from vgd_tpu_torch.utils.prefetch import PinnedRing

# row shapes: the 64x64 and 256x256 faces, one channel, an odd row size
ROWS = [(64, 64, 3), (256, 256, 3), (16, 16, 1), (7, 5, 3)]
THREADS = [1, 2, 8]


def _data(shape, n=24, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n,) + shape,
                                                dtype=np.uint8)


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """Both packages' libraries built, so JAX's side is its native path
    (JAX's library is written in place; another test process may be
    writing it, so its load is retried)."""
    for _ in range(20):
        if JN.available():
            break
        time.sleep(0.5)
    assert JN.available()
    PN.build()


@pytest.mark.parametrize("n_threads", THREADS)
@pytest.mark.parametrize("shape", ROWS)
@pytest.mark.parametrize("batch", [11, 3])
def test_gather_batch_matches_jax_and_numpy(shape, n_threads, batch):
    """Unsorted, repeated indices; a batch of 3 is smaller than 8 threads."""
    data = _data(shape)
    idx = np.random.default_rng(batch).integers(0, len(data), batch)
    idx[-1] = idx[0]
    got = PN.gather_batch(data, idx, n_threads=n_threads)
    assert got.tobytes() == JN.gather_batch(data, idx,
                                            n_threads=n_threads).tobytes()
    assert got.tobytes() == data[idx].tobytes()


@pytest.mark.parametrize("n_threads", THREADS)
def test_signed_f32_bit_equal_to_jax(n_threads):
    data = _data((9, 7, 3))
    idx = np.array([5, 1, 5, 23, 0])
    got = PN.gather_batch_signed_f32(data, idx, n_threads=n_threads)
    want = JN.gather_batch_signed_f32(data, idx, n_threads=n_threads)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    assert np.abs(got - (data[idx] / 127.5 - 1.0)).max() < 1e-6


@pytest.mark.parametrize("n_threads", [1, 8])
@pytest.mark.parametrize("entry", ["out", "offset"])
def test_out_and_offset_write_only_their_slots(entry, n_threads):
    data = _data((5, 4, 3))
    idx = np.array([7, 2, 2, 19])
    dst = np.full((10,) + data.shape[1:], 0xAB, np.uint8)
    if entry == "out":
        out = PN.gather_batch(data, idx, out=dst[3:7], n_threads=n_threads)
        assert out.base is dst or np.shares_memory(out, dst)
    else:
        PN.gather_rows_at(data, idx, dst, 3, n_threads=n_threads)
    np.testing.assert_array_equal(dst[3:7], data[idx])
    assert (dst[:3] == 0xAB).all() and (dst[7:] == 0xAB).all()


@pytest.mark.parametrize("bad", ["index", "rows", "dtype", "strided"])
def test_gather_refuses_what_it_cannot_read(bad):
    data = _data((4, 4, 3))
    dst = np.zeros((3,) + data.shape[1:], np.uint8)
    args = {"index": (data, [0, 24], dst, 0),
            "rows": (data, [0, 1], dst, 2),
            "dtype": (data.astype(np.int16), [0], dst, 0),
            "strided": (data[:, ::2], [0], dst[:, ::2], 0)}[bad]
    with pytest.raises((IndexError, ValueError)):
        PN.gather_rows_at(*args)


@pytest.mark.parametrize("fault", ["no compiler", "bad source"])
def test_failed_build_raises_naming_the_compiler(fault, monkeypatch,
                                                 tmp_path):
    monkeypatch.setattr(PN, "BUILD_DIR", tmp_path / "native")
    if fault == "no compiler":
        monkeypatch.delenv("CXX", raising=False)
        monkeypatch.setenv("PATH", str(tmp_path))
        match = r"g\+\+"
    else:
        src = tmp_path / "gather.cpp"
        src.write_text("this is not C++\n")
        monkeypatch.setattr(PN, "SOURCE", src)
        match = r"failed to build(.|\n)*error"
    with pytest.raises(RuntimeError, match=match):
        PN.build()
    assert not list((tmp_path / "native").glob("*.so"))


def test_loader_streams_match_jax():
    """Two shuffled epochs, the padded eval pass, and stream() from 0 and
    resumed mid-epoch: the same bytes as JAX's native Loader; the
    selections are the batches' sorted indices."""
    cfg = dict(image_size=(8, 8), batch_size=4, dataset_size=22)
    from vgd_tpu.core import config as JC
    from vgd_tpu_torch.core import config as PC
    tj, vj, _ = JDATA.make_image_datasets(JC.DataConfig(**cfg), seed=3)
    tp, vp, _ = PDATA.make_image_datasets(PC.DataConfig(**cfg), seed=3)
    for loaders in ((tj, tp), (tj, tp), (vj, vp)):
        want, got = (list(ld.epoch()) for ld in loaders)
        assert [n for _, n in got] == [n for _, n in want] and got
        for (bp, _), (bj, _) in zip(got, want):
            assert bp.tobytes() == bj.tobytes()
    sel = list(vp.selections())
    for (bp, _), (s, _) in zip(vp.epoch(), sel):
        assert bp.tobytes() == vp.ds.array[s].tobytes()
        assert (np.diff(s) >= 0).all()
    twin = PDATA.Loader(tp.ds, tp.indices, 4, shuffle=True, seed=3)
    for start in (0, 3, 9):
        sj, sp = tj.stream(start), tp.stream(start)
        sels = twin.stream_selections(start)
        for _ in range(7):
            bj = next(sj)
            assert next(sp).tobytes() == bj.tobytes()
            assert tp.ds.array[next(sels)].tobytes() == bj.tobytes()


def _numpy_chunks(data, sels, per, steps, mesh):
    """The staging of JAX's streaming scan: ``np.stack`` of up to ``per``
    numpy gathers of this rank's rows at a time, ``steps`` in all."""
    batches = [mesh.rows(data[s]) for s in sels][:steps]
    return [np.stack(batches[i:i + per])
            for i in range(0, len(batches), per)]


@pytest.mark.parametrize("mesh", [LOCAL, Mesh(2, 1, 0), Mesh(2, 1, 1)],
                         ids=["one", "dp2-rank0", "dp2-rank1"])
@pytest.mark.parametrize("per,steps", [(3, 7), (4, 8), (3, 20), (1, 5)])
def test_chunk_stager_matches_numpy_stack(mesh, per, steps):
    """The scan's stager (chunks of ``per`` steps, the last shorter) and the
    per-step loop's (one batch a buffer): the bytes of np.stack of numpy
    gathers of ``Mesh.rows`` of each selection, through both prefetch
    depths; the ring's buffers are reused."""
    data = _data((6, 5, 3), n=40)
    loader = PDATA.Loader(PDATA.ArrayDataset(data), np.arange(5, 38), 4,
                          shuffle=True, seed=1)
    sels = [s for s, _ in loader.selections()]
    want = _numpy_chunks(data, sels, per, steps, mesh)
    for prefetch in (L.SCAN_PREFETCH, L.STEP_PREFETCH):
        st = L._Staging(data, 4, mesh, "cpu", per, prefetch)
        got = [c.clone() for c in st.chunks(iter(sels), steps)]
        assert [tuple(c.shape) for c in got] == [c.shape for c in want]
        for g, w in zip(got, want):
            assert g.numpy().tobytes() == w.tobytes()
        assert st.ring.turn == len(want)
    st = L._Staging(data, 4, mesh, "cpu", 1, L.STEP_PREFETCH)
    got = [b.clone() for b in st.batches(iter(sels), steps)]
    assert b"".join(g.numpy().tobytes() for g in got) == \
        b"".join(w.tobytes() for w in want)


def test_ring_waits_on_a_buffers_copy_before_refilling_it():
    """``stage`` fills the buffers in turn, each only after waiting on its
    last copy's event, and hands back (on the CPU) the view of its first
    ``n`` rows; the gather's thread count follows the bytes."""
    ring = PinnedRing((3, 2), "cpu", slots=2)
    waited, filled = [], []

    class Event:
        def __init__(self, k):
            self.k = k

        def synchronize(self):
            waited.append(self.k)

    def fill(buf):
        filled.append((buf.data_ptr(), list(waited)))
        buf.fill_(len(filled))
    out = ring.stage(fill, 2)
    assert out.shape == (2, 2) and out.data_ptr() == ring.buffers[0].data_ptr()
    ring.events = [Event(0), Event(1)]
    ring.stage(fill, 3)
    ring.stage(fill, 3)
    assert filled == [(ring.buffers[0].data_ptr(), []),
                      (ring.buffers[1].data_ptr(), [1]),
                      (ring.buffers[0].data_ptr(), [1, 0])]
    assert ring.events == [None, None] and ring.turn == 3
    assert (out == 3).all()
    with pytest.raises(ValueError):
        PinnedRing((3, 2), "cpu", slots=1)
    cap = PN.default_threads()
    assert [PN.threads_for(n) for n in (0, 64 * 64 * 64 * 3,
                                        64 * 256 * 256 * 3, 1 << 40)] == \
        [1, 1, min(3, cap), cap]
