"""The tensor-parallel pieces alone, in one process.

* ``common.cross_entropy`` over vocab-sharded logits and
  ``common.apply_norm`` over channel-sharded input (mamba's gated norm),
  each rank's shard of a whole input run in turn in this process: the
  model axis's all-reduces (``common.all_reduce``) are replayed, each
  call given the sum (or max) of the ranks' operands of the same call in
  the pass before, until a pass changes nothing.  The losses and outputs
  against the whole input's, the gradients of the shards concatenated
  against the whole's.
* ``sharding.compute_slice`` of ``w_xz``, ``wk``/``wv`` and ``wq``
  against the rule table's storage shards (``sharding.shard_slices``) at
  a model axis of 2, 4 and 16, on the full configs' shapes.
* ``common.head_ranges`` and ``common.partition``: every head and column
  computed by exactly one rank, or a KV head by the ranks whose query
  heads read it.
"""

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch import sharding as shd
from repro_torch.models import common

TOL = dict(rtol=1e-6, atol=1e-6)


class Replay:
    """The ranks of a model axis run one after the other: each all-reduce
    returns the reduction of the ranks' operands of the same call in the
    previous pass (its own operand in the first)."""

    def __init__(self, size: int):
        self.size, self.prev, self.calls = size, None, None
        self.rank = 0

    def all_reduce(self, t, group, op=dist.ReduceOp.SUM):
        self.calls[self.rank].append(t.detach().clone())
        if self.prev is None:
            return t.detach().clone()
        i = len(self.calls[self.rank]) - 1
        ops = torch.stack([self.prev[r][i] for r in range(self.size)])
        return ops.max(0).values if op == dist.ReduceOp.MAX else ops.sum(0)

    def run(self, fn, passes: int = 6):
        """``fn(rank, tp)`` for every rank until a pass repeats the last's
        collectives -> each rank's result."""
        for _ in range(passes):
            self.calls = [[] for _ in range(self.size)]
            out = []
            for r in range(self.size):
                self.rank = r
                out.append(fn(r, common.TensorParallel(None, r, self.size)))
            if self.prev is not None and all(
                    len(a) == len(b) and all(torch.equal(x, y)
                                             for x, y in zip(a, b))
                    for a, b in zip(self.calls, self.prev)):
                return out
            self.prev = self.calls
        raise AssertionError("the replay did not settle")


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_vocab_parallel_cross_entropy_matches_the_whole(monkeypatch, size,
                                                        masked):
    g = torch.Generator().manual_seed(size)
    logits = torch.randn(3, 7, 48, generator=g) * 3.0
    labels = torch.randint(0, 48, (3, 7), generator=g)
    mask = (torch.rand(3, 7, generator=g) > 0.3).float() if masked else None
    whole = logits.clone().requires_grad_()
    want, wm = common.cross_entropy(whole, labels, mask)
    (want_g,) = torch.autograd.grad(want, whole)
    replay = Replay(size)
    monkeypatch.setattr(common, "all_reduce", replay.all_reduce)
    cols = 48 // size

    def rank(r, tp):
        x = logits[..., r * cols:(r + 1) * cols].clone().requires_grad_()
        loss, m = common.cross_entropy(x, labels, mask, tp=tp,
                                       vocab_start=r * cols)
        (gx,) = torch.autograd.grad(loss, x)
        return loss.detach(), {k: v.detach() for k, v in m.items()}, gx

    out = replay.run(rank)
    for loss, m, _ in out:  # every rank holds the whole batch's loss
        torch.testing.assert_close(loss, want.detach(), **TOL)
        for k in ("nll", "z_loss", "tokens"):
            torch.testing.assert_close(m[k], wm[k].detach(), **TOL)
    torch.testing.assert_close(torch.cat([gx for *_, gx in out], -1),
                               want_g, **TOL)


@pytest.mark.parametrize("size", [2, 4])
def test_sharded_norm_matches_the_whole(monkeypatch, size):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 5, 64, generator=g)
    scale = 1.0 + 0.1 * torch.randn(64, generator=g)
    dy = torch.randn(2, 5, 64, generator=g)
    wx, ws = x.clone().requires_grad_(), scale.clone().requires_grad_()
    want = common.apply_norm({"scale": ws}, wx)
    want_gx, want_gs = torch.autograd.grad(want, (wx, ws), dy)
    replay = Replay(size)
    monkeypatch.setattr(common, "all_reduce", replay.all_reduce)
    c = 64 // size

    def rank(r, tp):
        part = slice(r * c, (r + 1) * c)
        xs = x[..., part].clone().requires_grad_()
        ss = scale[part].clone().requires_grad_()
        y = common.apply_norm({"scale": ss}, xs, tp=tp, channels=64)
        gx, gs = torch.autograd.grad(y, (xs, ss), dy[..., part])
        return y.detach(), gx, gs

    out = replay.run(rank)
    torch.testing.assert_close(torch.cat([y for y, _, _ in out], -1),
                               want.detach(), **TOL)
    torch.testing.assert_close(torch.cat([gx for _, gx, _ in out], -1),
                               want_gx, **TOL)
    torch.testing.assert_close(torch.cat([gs for *_, gs in out]), want_gs,
                               **TOL)


def _storage(names, shape, model: int, rank: int):
    """The rule table's shard of a leaf on a (1, model) mesh, at the rank
    ``rank`` of ``model`` (the mesh is the fake process group's)."""
    from repro_torch.launch import mesh as pmesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=model)
    try:
        mesh = pmesh.make_local_mesh(1, model, device="cpu")
        sh = shd.to_named_sharding(mesh, shd.param_logical_spec(names),
                                   shape)
        return shd.shard_slices(sh, shape, (0, rank))
    finally:
        dist.destroy_process_group()


def _columns(sl):
    dim, ranges = sl
    return dim, [c for a, b in ranges for c in range(a, b)]


@pytest.mark.parametrize("model", [2, 4, 16])
def test_w_xz_slice_holds_both_halves_of_the_ranks_heads(model):
    cfg = get_config("mamba2-2.7b")
    di, P = cfg.ssm_d_inner, cfg.ssm_head_dim
    shape = (cfg.d_model, 2 * di)
    names = ["blocks", "[0]", "mamba", "w_xz"]
    seen = []
    for r in range(model):
        h0, h1 = common.partition(cfg.ssm_heads, model, r)
        dim, cols = _columns(shd.compute_slice(names, shape, cfg, model, r))
        assert dim == 1
        assert cols == list(range(h0 * P, h1 * P)) + list(
            range(di + h0 * P, di + h1 * P))
        stored = _storage(names, shape, model, r)[1]
        # the storage shard holds x columns or z columns, never both
        assert stored.stop <= di or stored.start >= di
        seen += cols
    assert sorted(seen) == list(range(2 * di))


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-72b", "dbrx-132b",
                                  "jamba-v0.1-52b", "internvl2-1b"])
@pytest.mark.parametrize("model", [2, 4, 16])
def test_kv_slices_are_whole_kv_heads_of_the_query_heads(arch, model):
    cfg = get_config(arch)
    D = cfg.head_dim
    group = cfg.num_heads // cfg.num_kv_heads
    shape = (cfg.d_model, cfg.num_kv_heads * D)
    q_seen, kv_readers = [], {}
    for r in range(model):
        q0, q1, k0, k1 = common.head_ranges(cfg.num_heads, cfg.num_kv_heads,
                                            model, r)
        for name in ("wk", "wv"):
            names = ["blocks", "[0]", "attn", name]
            sl = shd.compute_slice(names, shape, cfg, model, r)
            cols = (list(range(shape[1])) if sl is None
                    else _columns(sl)[1])
            assert cols == list(range(k0 * D, k1 * D))  # whole KV heads
        for h in range(q0, q1):  # each query head's KV head is the rank's
            assert k0 <= h // group < k1
            kv_readers.setdefault(h // group, set()).add(r)
        q_seen += list(range(q0, q1))
        if cfg.num_kv_heads < model:  # the rule table cuts a KV head
            stored = _storage(["blocks", "[0]", "attn", "wk"], shape, model,
                              r)[1]
            assert (stored.stop - stored.start) < D
    assert q_seen == list(range(cfg.num_heads))
    assert set(kv_readers) == set(range(cfg.num_kv_heads))


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "internvl2-1b"])
def test_indivisible_query_heads_go_first_to_the_low_ranks(arch):
    """qwen1.5-4b's 20 and internvl2-1b's 14 query heads on 16 ranks: the
    first ranks take one more; rank 0 (the dry run's) has the most."""
    cfg = get_config(arch)
    counts = [q1 - q0 for q0, q1, _, _ in (
        common.head_ranges(cfg.num_heads, cfg.num_kv_heads, 16, r)
        for r in range(16))]
    assert sum(counts) == cfg.num_heads
    assert counts[0] == max(counts) and max(counts) - min(counts) <= 1
    shape = (cfg.d_model, cfg.num_heads * cfg.head_dim)
    sl = shd.compute_slice(["blocks", "[0]", "attn", "wq"], shape, cfg, 16,
                           0)
    assert _columns(sl)[1] == list(range(counts[0] * cfg.head_dim))


def test_partition_and_one_rank_slices():
    assert [common.partition(20, 16, r) for r in (0, 3, 4, 15)] == \
        [(0, 2), (6, 8), (8, 9), (19, 20)]
    cfg = get_config("llama3-8b", "smoke")
    # one rank computes with every leaf whole
    for names, shape in ((["blocks", "[0]", "attn", "wk"], (64, 32)),
                         (["blocks", "[0]", "ffn", "w_down"], (128, 64)),
                         (["embed"], (512, 64))):
        assert shd.compute_slice(names, shape, cfg, 1, 0) is None
