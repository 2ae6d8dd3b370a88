"""The port's vote-NMS (radet_tpu_torch/ops/vote_nms.py) against the JAX
package: the Pallas kernel in interpret mode, the XLA formulation
``vote_nms_device_fast(presorted=True)`` and the sequential numpy oracle.

Tolerances are those of tests/test_pallas_nms.py: boxes rtol 1e-3 /
atol 1e-2 px against the float64 oracle (float32 vote sums), labels and keep
sets exact, scores rtol 1e-5 (they are copied, not computed).

The kernel-vs-plain cases need a CUDA card and skip without one.  The card's
machine has no JAX, so this module imports JAX only inside the tests that
compare with it; run the card's cases there with
``python -m pytest --noconftest -m cuda tests/test_torch_vote_nms.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import radet_tpu_torch.ops.vote_nms_cuda as cuda_mod
from radet_tpu_torch.ops.vote_nms import batched_nms, batched_nms_plain, pairwise_iou, vote_nms, vote_nms_plain

THR = 0.5


def _sorted_dets(rng, n_real, num_labels=3, k=128):
    """Clustered candidates sorted by cluster score, invalid slots last (as
    tests/test_pallas_nms.py makes them)."""
    centers = rng.uniform(50, 400, (8, 2))
    idx = rng.randint(0, 8, n_real)
    cx = centers[idx, 0] + rng.randn(n_real) * 3
    cy = centers[idx, 1] + rng.randn(n_real) * 3
    w = rng.uniform(40, 60, n_real)
    h = rng.uniform(40, 60, n_real)
    boxes = np.zeros((k, 4), np.float32)
    boxes[:n_real] = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    cluster = np.zeros(k, np.float32)
    cluster[:n_real] = np.sort(rng.uniform(0.1, 1.0, n_real))[::-1]
    vote = np.zeros(k, np.float32)
    vote[:n_real] = rng.uniform(0.1, 1.0, n_real)
    labels = np.zeros(k, np.int32)
    labels[:n_real] = (idx % num_labels).astype(np.int32)
    valid = np.zeros(k, bool)
    valid[:n_real] = True
    return boxes, cluster, vote, labels, valid


@pytest.fixture(scope="module")
def ref():
    """The JAX package's vote-NMS implementations."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from radet_tpu.ops.pallas_nms import vote_nms_pallas
    from radet_tpu.ops.vote_nms import vote_nms_device_fast, vote_nms_numpy
    from test_vote_nms import _random_dets

    def fast(arrays, **kw):
        out = jax.vmap(lambda *xs: vote_nms_device_fast(*xs, presorted=True, **kw))(
            *(jnp.asarray(a) for a in arrays)
        )
        return list(map(np.asarray, out))

    def references(arrays, **kw):
        pallas = vote_nms_pallas(*(jnp.asarray(a) for a in arrays), interpret=True, **kw)
        return [list(map(np.asarray, pallas)), fast(arrays, **kw)]

    return SimpleNamespace(references=references, fast=fast, oracle=vote_nms_numpy,
                           random_dets=_random_dets)


def _presort(boxes, cluster, vote, labels):
    """Sort candidates by cluster score descending (the contract of the
    presorted NMS)."""
    order = np.argsort(-cluster, kind="stable")
    return boxes[order], cluster[order], vote[order], labels[order]


def _plain(arrays, **kw):
    boxes, cluster, vote, labels, valid = (torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    out = vote_nms_plain(boxes, cluster, vote, labels.to(torch.int32), valid.bool(), **kw)
    return [t.numpy() for t in out]


def _check_oracle(db, dl, dsc, dv, oracle, rtol=1e-3, atol=1e-2):
    ob, ol, osc = oracle
    n = int(dv.sum())
    assert n == min(len(ob), len(dv))
    assert dv[:n].all() and not dv[n:].any()
    np.testing.assert_allclose(db[:n], ob[:n], rtol=rtol, atol=atol)
    np.testing.assert_array_equal(dl[:n], ol[:n])
    np.testing.assert_allclose(dsc[:n], osc[:n], rtol=1e-5)
    assert (dl[n:] == -1).all() and (db[n:] == 0).all() and (dsc[n:] == 0).all()


def _check_same(a, b):
    """Two vote-NMS results: the same keep set, labels and scores; boxes to
    the oracle tolerance."""
    (ab, al, asc, av), (bb, bl, bsc, bv) = a, b
    np.testing.assert_array_equal(av, bv)
    np.testing.assert_array_equal(al, bl)
    np.testing.assert_array_equal(asc, bsc)
    np.testing.assert_allclose(ab, bb, rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("global_mode", [False, True])
@pytest.mark.parametrize("iou_enable", [False, True])
def test_plain_matches_jax_and_oracle(ref, rng, global_mode, iou_enable):
    kw = dict(iou_threshold=THR, max_out=50, iou_enable=iou_enable, sigma=0.025,
              global_mode=global_mode)
    images = [_sorted_dets(rng, n_real=60) for _ in range(3)]
    arrays = [np.stack(x) for x in zip(*images)]
    plain = _plain(arrays, **kw)
    for expected in ref.references(arrays, **kw):
        _check_same(plain, expected)
    for i, (boxes, cluster, vote, labels, _) in enumerate(images):
        oracle = ref.oracle(
            boxes[:60], cluster[:60], vote[:60], labels[:60], THR, iou_enable, 0.025, global_mode
        )
        _check_oracle(*(x[i] for x in plain), oracle)


@pytest.mark.parametrize("global_mode", [False, True])
def test_plain_multitile_matches_jax_and_oracle(ref, rng, global_mode):
    """K=256 with candidates spanning both of the TPU kernel's 128-tiles."""
    k, n = 256, 220
    kw = dict(iou_threshold=THR, max_out=100, global_mode=global_mode)
    boxes, cluster, vote, labels, valid = _sorted_dets(rng, n_real=n, k=k)
    arrays = [x[None] for x in (boxes, cluster, vote, labels, valid)]
    plain = _plain(arrays, **kw)
    for expected in ref.references(arrays, **kw):
        _check_same(plain, expected)
    oracle = ref.oracle(
        boxes[:n], cluster[:n], vote[:n], labels[:n], THR, False, 0.025, global_mode
    )
    _check_oracle(*(x[0] for x in plain), oracle)


def test_plain_empty_input():
    k = 128
    arrays = [np.zeros((2, k, 4), np.float32), np.zeros((2, k), np.float32),
              np.zeros((2, k), np.float32), np.zeros((2, k), np.int32), np.zeros((2, k), bool)]
    db, dl, dsc, dv = _plain(arrays, iou_threshold=0.65, max_out=10)
    assert db.shape == (2, 10, 4) and not dv.any()
    assert (dl == -1).all() and (db == 0).all() and (dsc == 0).all()


def test_plain_degenerate_box_self_membership(ref, rng):
    """A kept zero-area box emits its own coordinates (forced
    self-membership), as the Pallas kernel and the XLA formulation do."""
    boxes, cluster, vote, labels, valid = _sorted_dets(rng, n_real=20)
    boxes[3] = (77.0, 50.0, 77.0, 120.0)
    labels[3] = 2
    labels[:3] = 0
    kw = dict(iou_threshold=THR, max_out=50)
    arrays = [x[None] for x in (boxes, cluster, vote, labels, valid)]
    plain = _plain(arrays, **kw)
    for expected in ref.references(arrays, **kw):
        _check_same(plain, expected)
    db, _, _, dv = plain
    assert any(np.allclose(e, boxes[3], atol=1e-3) for e in db[0][dv[0]])


def test_plain_deep_chain(ref):
    """Chained overlaps (each box overlaps only its neighbours) need several
    rounds of the greedy fixed point."""
    n = 12
    boxes = np.stack(
        [10.0 * np.arange(n), np.zeros(n), 10.0 * np.arange(n) + 40, np.full(n, 40.0)], -1
    ).astype(np.float32)
    cluster = np.linspace(1.0, 0.5, n).astype(np.float32)
    vote = np.ones(n, np.float32)
    labels = np.zeros(n, np.int32)
    oracle = ref.oracle(boxes, cluster, vote, labels, THR, False, 0.025, False)
    arrays = [x[None] for x in (boxes, cluster, vote, labels, np.ones(n, bool))]
    plain = _plain(arrays, iou_threshold=THR, max_out=12)
    _check_oracle(*(x[0] for x in plain), oracle, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n_valid", [40, 25])
def test_plain_truncation(ref, rng, n_valid):
    """max_out below the number of clusters keeps the highest-scored ones;
    invalid slots never take part."""
    boxes, cluster, vote, labels = _presort(*ref.random_dets(rng, n=40))
    valid = np.arange(40) < n_valid
    oracle = ref.oracle(
        boxes[:n_valid], cluster[:n_valid], vote[:n_valid], labels[:n_valid],
        THR, False, 0.025, False,
    )
    assert len(oracle[0]) > 3
    arrays = [x[None] for x in (boxes, cluster, vote, labels, valid)]
    plain = _plain(arrays, iou_threshold=THR, max_out=3)
    _check_oracle(*(x[0] for x in plain), oracle)


def test_dispatch_cpu_runs_plain_and_kernel_wrapper_refuses_cpu():
    rng = np.random.RandomState(0)
    arrays = [np.stack(x) for x in zip(*[_sorted_dets(rng, n_real=30) for _ in range(2)])]
    tensors = [torch.from_numpy(a) for a in arrays]
    tensors[3] = tensors[3].to(torch.int32)
    before = cuda_mod.LAUNCHES
    out = vote_nms(*tensors, iou_threshold=THR, max_out=20)
    assert cuda_mod.LAUNCHES == before
    _check_same([t.numpy() for t in out], _plain(arrays, iou_threshold=THR, max_out=20))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_mod.vote_nms_cuda(*tensors, iou_threshold=THR, max_out=20)


def _pack_bits(bits):
    """(..., n) bool -> (..., ceil(n / 32)) uint32 words, bit b of word w
    being element 32 w + b."""
    n = bits.shape[-1]
    padded = np.zeros(bits.shape[:-1] + (-(-n // 32) * 32,), bool)
    padded[..., :n] = bits
    groups = padded.reshape(bits.shape[:-1] + (-1, 32)).astype(np.uint64)
    return (groups << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def _emulate_kernel(boxes, vote, labels, valid, iou_threshold, max_out, global_mode):
    """The data flow of csrc/vote_nms.cu on one image, in numpy: the bitmask
    stored as upper-triangle 32-bit words (the diagonal word whole, the
    words left of it never written), the greedy keep one word at a time
    (a ballot fixed point inside the word, then the kept rows' later words
    ORed into ``removed``), global dedup, ranks, seeds from the columns of
    the emitted final-kept rows, the counting sort by seed rank, and voting
    over each seed's members (float64).  Returns (boxes, keep-ordered
    indices of the final-kept boxes, seed of each box or -1)."""
    k = len(boxes)
    nw = -(-k // 32)
    b = boxes.astype(np.float32)
    area = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    w = np.maximum(np.minimum(b[:, None, 2], b[None, :, 2]) - np.maximum(b[:, None, 0], b[None, :, 0]), 0)
    h = np.maximum(np.minimum(b[:, None, 3], b[None, :, 3]) - np.maximum(b[:, None, 1], b[None, :, 1]), 0)
    inter = w * h
    iou = inter / np.maximum(area[:, None] + area[None, :] - inter, np.float32(1e-12))
    over = (labels[:, None] == labels[None, :]) & valid[:, None] & valid[None, :] & (iou > iou_threshold)
    # 1. upper-triangle words; the rest holds a pattern no read may see
    words = np.full((k, nw), 0xDEADBEEF, np.uint32)
    packed = _pack_bits(over)
    for i in range(k):
        words[i, i // 32:] = packed[i, i // 32:]

    def row_word(i, v):
        assert v >= i // 32, "read left of the diagonal word"
        return int(words[i, v])

    # 2. greedy keep, word by word
    valid_w = [int(x) for x in _pack_bits(valid)]
    removed = [0] * nw
    keep_w = [0] * nw
    for wd in range(nw):
        diag = [row_word(32 * wd + l, wd) if 32 * wd + l < k else 0 for l in range(32)]
        cand = valid_w[wd] & ~removed[wd]
        keep = cand
        while cand:
            nxt = sum(1 << l for l in range(32)
                      if (cand >> l) & 1 and not diag[l] & ((1 << l) - 1) & keep)
            if nxt == keep:
                break
            keep = nxt
        keep_w[wd] = keep
        for l in range(32):
            if (keep >> l) & 1:
                for v in range(wd + 1, nw):
                    removed[v] |= row_word(32 * wd + l, v)
    kept = [32 * wd + l for wd in range(nw) for l in range(32) if (keep_w[wd] >> l) & 1]
    # 3. global mode: the first kept box of each label
    final = [i for i in kept if not global_mode or all(labels[j] != labels[i] for j in kept if j < i)]
    fin_w = [int(x) for x in _pack_bits(np.isin(np.arange(k), final))]
    # 4. ranks
    rank0 = np.concatenate([[0], np.cumsum([bin(x).count("1") for x in fin_w])])
    n_out = min(len(final), max_out)
    # 5. seeds: per word of boxes, the emitted rows in rank order
    srank = np.full(k, -1)
    for v in range(nw):
        fin = fin_w[v]
        for l in range(32):
            j = 32 * v + l
            if j < k and (fin >> l) & 1:
                r = rank0[v] + bin(fin & ((1 << l) - 1)).count("1")
                srank[j] = r if r < max_out else -1
        open_ = valid_w[v] & ~fin
        n_rows = min(n_out, rank0[v] + bin(fin).count("1"))
        for t in range(n_rows):
            if not open_:
                break
            i = final[t]
            x = row_word(i, v)
            if i // 32 == v:
                x &= ~((2 << (i & 31)) - 1) & 0xFFFFFFFF
            hit = x & open_
            for l in range(32):
                if (hit >> l) & 1:
                    srank[32 * v + l] = t
            open_ &= ~hit
    # 6. members by seed rank, in index order (the stable counting sort)
    members = [np.flatnonzero(srank == r) for r in range(n_out)]
    # 7. voting over members only
    out = np.zeros((max_out, 4))
    for r, m in enumerate(members):
        assert m[0] == final[r], "a seed is its own first member"
        x = boxes[m].astype(np.float64)
        wt = vote[m].astype(np.float64)
        ws = max(wt.sum(), 1e-12)
        mean = (wt[:, None] * x).sum(0) / ws
        sig = np.sqrt(np.maximum((wt[:, None] * (x - mean) ** 2).sum(0) / ws, 0))
        inl = (x >= mean - sig) & (x <= mean + sig)
        den = (wt[:, None] * inl).sum(0)
        out[r] = np.where(den > 0, (wt[:, None] * inl * x).sum(0) / np.maximum(den, 1e-12), mean)
    seed = np.where(srank >= 0, np.asarray(final + [-1])[srank], -1)
    return out, np.asarray(final, int), seed


def _dense_seeds(boxes, labels, valid, final, iou_threshold, max_out):
    """Seeds by the plain version's dense rule: the lowest-index final-kept
    box overlapping each box (a kept box itself), -1 without one or when
    that seed's rank is >= max_out."""
    k = len(boxes)
    iou = pairwise_iou(torch.from_numpy(boxes[None]).double())[0].numpy()
    over = (labels[:, None] == labels[None, :]) & valid[:, None] & valid[None, :] & (iou > iou_threshold)
    keep = np.isin(np.arange(k), final)
    cand = over & keep[:, None] & (np.arange(k)[:, None] <= np.arange(k)[None, :])
    cand[np.arange(k), np.arange(k)] = keep
    seed = np.where(cand.any(0), cand.argmax(0), -1)
    rank = np.cumsum(keep) - 1
    return np.where((seed >= 0) & (rank[np.maximum(seed, 0)] < max_out), seed, -1)


def _emulation_cases():
    """(boxes, cluster, vote, labels, valid, max_out) of one image by name."""
    rng = np.random.RandomState(11)
    clustered = _sorted_dets(rng, n_real=200, num_labels=3, k=256)
    n = 100  # each box overlaps only its neighbours (IoU 2/3, then 3/7): across 3 word edges
    chain = (np.stack([2.0 * np.arange(n), np.zeros(n), 2.0 * np.arange(n) + 10, np.full(n, 10.0)],
                      -1).astype(np.float32),
             np.linspace(1.0, 0.5, n).astype(np.float32), np.ones(n, np.float32),
             np.zeros(n, np.int32), np.ones(n, bool))
    boxes, cluster, vote, labels, valid = _sorted_dets(rng, n_real=20, k=40)
    boxes[3] = (77.0, 50.0, 77.0, 120.0)
    labels[3] = 2
    labels[:3] = 0
    degenerate = (boxes, cluster, vote, labels, valid)
    interleaved = list(_sorted_dets(rng, n_real=150, num_labels=2, k=150))
    interleaved[4] = rng.rand(150) < 0.6
    odd = _sorted_dets(rng, n_real=45, num_labels=2, k=45)
    return {
        "clustered": (*clustered, 100),
        "deep_chain": (*chain, 100),
        "degenerate": (*degenerate, 50),
        "truncation": (*clustered, 3),
        "interleaved_invalid": (*interleaved, 100),
        "k_45": (*odd, 100),
    }


@pytest.mark.parametrize("global_mode", [False, True])
@pytest.mark.parametrize("case", sorted(_emulation_cases()))
def test_kernel_decomposition_emulated(ref, case, global_mode):
    """The kernel's decomposition (upper-triangle words, word-stepped greedy,
    dedup, seeds from the kept rows' columns, ranks, members by seed rank)
    emulated in numpy gives the keep set of the plain version and of the
    XLA formulation, the plain version's seeds, and its voted boxes."""
    boxes, cluster, vote, labels, valid, max_out = _emulation_cases()[case]
    kw = dict(iou_threshold=THR, max_out=max_out, global_mode=global_mode)
    voted, final, seed = _emulate_kernel(boxes, vote, labels, valid, THR, max_out, global_mode)
    n = min(len(final), max_out)
    arrays = [x[None] for x in (boxes, cluster, vote, labels, valid)]
    pb, pl, ps, pv = (x[0] for x in _plain([a.astype(np.float64) if a.dtype == np.float32 else a
                                              for a in arrays], **kw))
    assert pv[:n].all() and not pv[n:].any()
    np.testing.assert_array_equal(pl[:n], labels[final[:n]])
    np.testing.assert_array_equal(ps[:n], cluster[final[:n]])
    np.testing.assert_allclose(voted[:n], pb[:n], rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(seed, _dense_seeds(boxes, labels, valid, final, THR, max_out))
    fb, fl, fs, fv = (x[0] for x in ref.fast(arrays, **kw))
    np.testing.assert_array_equal(fv, pv)
    np.testing.assert_array_equal(fl, pl)
    np.testing.assert_array_equal(fs, ps.astype(np.float32))
    expected = {"deep_chain": 1 if global_mode else 50, "truncation": 3}
    assert n == expected.get(case, n)


@pytest.mark.parametrize("case", sorted(_emulation_cases()))
def test_no_vote_mode_decomposition_emulated(case):
    """The no-vote mode's data flow (the same bitmask and word-stepped
    greedy keep; each kept box copied into its slot) gives the slots of
    ``batched_nms_plain`` and of the JAX package's ``batched_nms_device``
    on candidates sorted by score."""
    from radet_tpu.ops.vote_nms import batched_nms_device

    boxes, cluster, _, labels, valid, max_out = _emulation_cases()[case]
    _, final, _ = _emulate_kernel(boxes, cluster, labels, valid, THR, max_out, False)
    n = min(len(final), max_out)
    pb, pl, ps, pv = (x[0].numpy() for x in batched_nms_plain(
        *(torch.from_numpy(a[None]) for a in (boxes, cluster, labels, valid)), iou_threshold=THR, max_out=max_out))
    assert pv[:n].all() and not pv[n:].any()
    np.testing.assert_array_equal(pb[:n], boxes[final[:n]])
    np.testing.assert_array_equal(pl[:n], labels[final[:n]])
    np.testing.assert_array_equal(ps[:n], cluster[final[:n]])
    ref = batched_nms_device(boxes, cluster, labels, valid, iou_threshold=THR, max_out=max_out)
    for got, want in zip((pb, pl, ps, pv), ref):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_batched_nms_dispatch_cpu_runs_plain_and_kernel_wrapper_refuses_cpu():
    rng = np.random.RandomState(1)
    boxes, cluster, _, labels, valid = (torch.from_numpy(np.stack(x))
                                        for x in zip(*[_sorted_dets(rng, n_real=30) for _ in range(2)]))
    before = cuda_mod.NMS_LAUNCHES, cuda_mod.LAUNCHES
    out = batched_nms(boxes, cluster, labels, valid, iou_threshold=THR, max_out=20)
    assert (cuda_mod.NMS_LAUNCHES, cuda_mod.LAUNCHES) == before
    for got, want in zip(out, batched_nms_plain(boxes, cluster, labels, valid, iou_threshold=THR, max_out=20)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_mod.batched_nms_cuda(boxes, cluster, labels, valid, iou_threshold=THR, max_out=20)


def _clustered_batch(rng, b, k, num_labels=5):
    """Synthetic clustered candidates, 60-100% valid, sorted per image."""
    images = []
    for _ in range(b):
        n_real = int(rng.randint(int(0.6 * k), k + 1))
        images.append(_sorted_dets(rng, n_real=n_real, num_labels=num_labels, k=k))
    return [np.stack(x) for x in zip(*images)]


def assert_kernel_matches_plain(kern, plain, tail=0.005, atol=1e-2):
    """Keep sets, labels and scores exact; boxes within ``atol`` px except a
    ``tail`` fraction of 1-sigma boundary flips.  Returns the max abs error."""
    kb, kl, ks, kv = (t.cpu().numpy() for t in kern)
    pb, pl, ps, pv = (t.cpu().numpy() for t in plain)
    np.testing.assert_array_equal(kv, pv)
    np.testing.assert_array_equal(kl, pl)
    np.testing.assert_array_equal(ks, ps)
    err = np.abs(kb - pb)[kv]
    assert (err > atol).mean() <= tail if err.size else True
    return float(err.max()) if err.size else 0.0


def test_kernel_size_check_takes_the_strict_eval_k():
    """The strict eval (apis/test.py::strict_eval_overrides) sends K = 2048
    candidates into vote-NMS, and the flagship's per-level candidate set at
    480x640 is 4 x 1000 + 420 = 4420: the kernel's size check takes both."""
    assert cuda_mod.MAX_K >= 8192
    for b, k in ((8, 2048), (16, 4420), (1, cuda_mod.MAX_K), (128, 512)):
        cuda_mod.check_sizes(b, k, 100)
    for b, k, m in ((1, cuda_mod.MAX_K + 1, 100), (0, 512, 100), (1, 0, 100), (1, 512, -1)):
        with pytest.raises(ValueError, match="MAX_K|max_out"):
            cuda_mod.check_sizes(b, k, m)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [128, 300, 512, 1024])
@pytest.mark.parametrize("global_mode", [False, True])
@pytest.mark.parametrize("iou_enable", [False, True])
def test_kernel_matches_plain(cuda_device, k, global_mode, iou_enable):
    rng = np.random.RandomState(k)
    arrays = _clustered_batch(rng, 16, k)
    tensors = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    tensors[3] = tensors[3].to(torch.int32)
    kw = dict(iou_threshold=0.65, max_out=100, iou_enable=iou_enable, sigma=0.025,
              global_mode=global_mode)
    before = cuda_mod.LAUNCHES
    kern = vote_nms(*tensors, **kw)
    torch.cuda.synchronize()
    assert cuda_mod.LAUNCHES == before + 1
    assert_kernel_matches_plain(kern, vote_nms_plain(*tensors, **kw))


def _plain_float64(tensors, **kw):
    """The plain version in float64 on the CPU, outputs back in float32."""
    plain = vote_nms_plain(*(t.cpu().double() if t.is_floating_point() else t.cpu() for t in tensors), **kw)
    return [t.float() if t.is_floating_point() else t for t in plain]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1025, 2048, 4420])
@pytest.mark.parametrize("global_mode", [False, True])
def test_kernel_above_1024_matches_plain(cuda_device, k, global_mode):
    """K > 1024 (the strict eval's K = 2048 and the flagship's largest
    per-level set), held to the plain version in float64 on the CPU.  At these cluster sizes (hundreds of members per
    seed) a float32 plain version is no steady reference: on the card (FMA
    contraction, scatter_add in atomic order) and on the CPU it strays from
    float64 on a few voted coordinates, not the same ones (0.0752 px on the
    CPU at K = 1025).  Keep sets, labels and scores are equal in float64
    too; the scores come back to float32 exactly (they are copied)."""
    rng = np.random.RandomState(k)
    arrays = _clustered_batch(rng, 16, k)
    tensors = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    tensors[3] = tensors[3].to(torch.int32)
    kw = dict(iou_threshold=0.65, max_out=100, global_mode=global_mode)
    before = cuda_mod.LAUNCHES
    kern = vote_nms(*tensors, **kw)
    torch.cuda.synchronize()
    assert cuda_mod.LAUNCHES == before + 1
    assert_kernel_matches_plain(kern, _plain_float64(tensors, **kw))
    # voting sums in a fixed order (no float atomics): the same bits again
    assert all(torch.equal(x, y) for x, y in zip(kern, vote_nms(*tensors, **kw)))


def _one_cluster(rng, k):
    """One image of ``k`` boxes of one label, each within 1 px of
    (100, 100, 150, 150): one seed with k - 1 members."""
    boxes = np.float32([100, 100, 150, 150]) + rng.uniform(-1, 1, (k, 4)).astype(np.float32)
    return [x[None] for x in (boxes, np.linspace(1.0, 0.1, k).astype(np.float32),
                              rng.uniform(0.1, 1.0, k).astype(np.float32), np.zeros(k, np.int32),
                              np.ones(k, bool))]


def _disjoint(k):
    """One image of ``k`` disjoint 8x8 boxes on a 10-px grid, labels 0-4: every
    box is kept, so the greedy sweep ORs every row of the bitmask."""
    i = np.arange(k)
    x, y = 10.0 * (i % 64), 10.0 * (i // 64)
    boxes = np.stack([x, y, x + 8, y + 8], -1).astype(np.float32)
    return [a[None] for a in (boxes, np.linspace(1.0, 0.1, k).astype(np.float32),
                              np.linspace(0.2, 0.9, k).astype(np.float32),
                              (i % 5).astype(np.int32), np.ones(k, bool))]


def _edge_cases():
    """Inputs at the kernel's edges: (arrays, kwargs) by name."""
    rng = np.random.RandomState(7)

    def one(*x):
        return [np.ascontiguousarray(a[None]) for a in x]

    empty = [np.zeros((2, 128, 4), np.float32), np.zeros((2, 128), np.float32),
             np.zeros((2, 128), np.float32), np.zeros((2, 128), np.int32), np.zeros((2, 128), bool)]
    boxes, cluster, vote, labels, valid = _sorted_dets(rng, n_real=20)
    boxes[3] = (77.0, 50.0, 77.0, 120.0)  # zero area, own label: kept, votes for itself
    labels[3] = 2
    labels[:3] = 0
    degenerate = one(boxes, cluster, vote, labels, valid)
    n = 12
    chain = one(
        np.stack([10.0 * np.arange(n), np.zeros(n), 10.0 * np.arange(n) + 40, np.full(n, 40.0)],
                 -1).astype(np.float32),
        np.linspace(1.0, 0.5, n).astype(np.float32), np.ones(n, np.float32),
        np.zeros(n, np.int32), np.ones(n, bool),
    )
    interleaved = _clustered_batch(rng, 4, 300)
    interleaved[4] = interleaved[4] & (rng.rand(4, 300) < 0.6)
    return {
        "empty": (empty, dict(max_out=10)),
        "single": ([a[:, :1] for a in _clustered_batch(rng, 3, 8)], dict(max_out=5)),
        "k_1": (_clustered_batch(rng, 3, 1), dict(max_out=5)),
        "k_33": (_clustered_batch(rng, 3, 33), dict(max_out=100)),
        "one_cluster_2048": (_one_cluster(rng, 2048), dict(max_out=100)),
        "disjoint_2048": (_disjoint(2048), dict(max_out=100)),
        "disjoint_2048_global": (_disjoint(2048), dict(max_out=100, global_mode=True)),
        "invalid_interleaved": (interleaved, dict(max_out=100)),
        "invalid_interleaved_global": (interleaved, dict(max_out=100, global_mode=True)),
        "b1_max_k": (_clustered_batch(rng, 1, cuda_mod.MAX_K), dict(max_out=100)),
        "degenerate": (degenerate, dict(iou_threshold=THR, max_out=50)),
        "degenerate_iou_enable": (degenerate, dict(iou_threshold=THR, max_out=50, iou_enable=True)),
        "deep_chain": (chain, dict(iou_threshold=THR, max_out=12)),
        "truncation": (_clustered_batch(rng, 4, 256), dict(max_out=3)),
        "max_out_0": (_clustered_batch(rng, 2, 64), dict(max_out=0)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_edge_cases()))
def test_kernel_edge_cases_match_plain(cuda_device, case):
    arrays, kw = _edge_cases()[case]
    tensors = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device) for a in arrays]
    tensors[3] = tensors[3].to(torch.int32)
    before = cuda_mod.LAUNCHES
    kern = vote_nms(*tensors, **kw)
    torch.cuda.synchronize()
    assert cuda_mod.LAUNCHES == before + 1
    plain = _plain_float64(tensors, **kw) if tensors[0].shape[1] > 1024 else vote_nms_plain(*tensors, **kw)
    assert kern[0].shape == plain[0].shape
    assert_kernel_matches_plain(kern, plain, tail=0.0)
    n_kept = kern[3].sum(1).tolist()
    if case == "one_cluster_2048":
        assert n_kept == [1]
    if case == "disjoint_2048":
        assert n_kept == [100]
    if case == "disjoint_2048_global":
        assert n_kept == [5]


def _nms_plain_float64(tensors, **kw):
    """``batched_nms_plain`` in float64 on the CPU, boxes and scores back in
    float32 (copies, so exactly the inputs' values)."""
    boxes, scores, labels, valid = (t.cpu() for t in tensors)
    out = batched_nms_plain(boxes.double(), scores.double(), labels, valid, **kw)
    return [t.float() if t.is_floating_point() else t for t in out]


def _nms_case(arrays):
    """(boxes, scores, labels, valid) of vote-NMS test arrays: the cluster
    score is the score, sorted descending with invalid slots last."""
    boxes, cluster, _, labels, valid = arrays
    return [np.ascontiguousarray(a) for a in (boxes, cluster, labels, valid)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,k", [(8, 1024), (16, 1024), (16, 2048), (4, 4420)])
def test_no_vote_kernel_matches_plain(cuda_device, b, k):
    """The no-vote mode against ``batched_nms_plain`` in float64: every slot
    equal, bit for bit (the slots are copies of the inputs)."""
    arrays = _nms_case(_clustered_batch(np.random.RandomState(k + b), b, k, num_labels=21))
    tensors = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    tensors[2] = tensors[2].to(torch.int32)
    kw = dict(iou_threshold=0.6, max_out=100)
    before = cuda_mod.NMS_LAUNCHES, cuda_mod.LAUNCHES
    kern = batched_nms(*tensors, **kw)
    torch.cuda.synchronize()
    assert (cuda_mod.NMS_LAUNCHES, cuda_mod.LAUNCHES) == (before[0] + 1, before[1])
    for got, want in zip(kern, _nms_plain_float64(tensors, **kw)):
        assert torch.equal(got.cpu(), want)
    assert kern[3].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(c for c in _edge_cases() if "global" not in c))
def test_no_vote_kernel_edge_cases_match_plain(cuda_device, case):
    arrays, kw = _edge_cases()[case]
    kw = {k: v for k, v in kw.items() if k in ("iou_threshold", "max_out")}
    tensors = [torch.from_numpy(a).to(cuda_device) for a in _nms_case(arrays)]
    tensors[2] = tensors[2].to(torch.int32)
    kern = batched_nms(*tensors, **kw)
    torch.cuda.synchronize()
    want = _nms_plain_float64(tensors, **kw)
    assert kern[0].shape == want[0].shape
    for got, w in zip(kern, want):
        assert torch.equal(got.cpu(), w)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_mod.batched_nms_cuda(*(t.cpu() for t in tensors), **kw)
