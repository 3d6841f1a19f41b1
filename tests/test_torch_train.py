"""The port's training pieces that hold no model, against the JAX
package on the CPU: AdamW (clipping on and off, a cosine schedule, bf16
parameters with fp32 state), ``cosine_schedule``, ``global_norm``, int8
error-feedback compression, the synthetic data and its prefetcher, the
checkpointer (mirrors of the reference's tests) and ``microbatch_policy``.
Inputs are made with numpy from a seed."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import Prefetcher as JPrefetcher
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch.train_step import microbatch_policy as j_microbatch_policy
from repro.optim import adamw as j_adamw
from repro.optim import compression as j_compression
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.launch.train_step import microbatch_policy
from repro_torch.optim import adamw, compression

SHAPES = {"a": (7, 5), "b": (13,), "c": (3, 4, 2)}  # sorted: JAX's order


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _tensors(tree, dtype=torch.float32):
    return [torch.from_numpy(tree[k]).to(dtype) for k in sorted(tree)]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------- AdamW

def _opt(module, case):
    """Each package's AdamW for ``case``: clipping on (the default) or
    off, a constant rate or a cosine schedule."""
    kw = dict(weight_decay=0.1, clip_norm=None if case == "no-clip" else 1.0)
    if case == "cosine":
        kw["learning_rate"] = module.cosine_schedule(1e-2, 2, 5)
    return module.AdamW(**kw)


@pytest.mark.parametrize("case", ["clip", "no-clip", "cosine", "bf16"])
def test_adamw_matches_reference_over_three_steps(case):
    """Three updates from the same params and gradients: params, m, v,
    count, grad_norm and lr within 1e-6 (bf16 params: equal to the bit,
    fp32 state)."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, scale=3.0 if case == "clip" else 0.05)
             for _ in range(3)]
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if case == "bf16"
                else (jnp.float32, torch.float32))
    jopt, topt = _opt(j_adamw, case), _opt(adamw, case)
    jp = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    tp = _tensors(params, tdt)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    assert all(m.dtype == torch.float32 for m in tstate.m + tstate.v)
    for g in grads:
        jp, jstate, jm = jopt.update(
            {k: jnp.asarray(v, jdt) for k, v in g.items()}, jstate, jp)
        tm = topt.update(_tensors(g, tdt), tstate, tp)
        for name in ("grad_norm", "lr"):
            assert tm[name].shape == () and tm[name].dtype == torch.float32
            _close(tm[name], jm[name], 1e-6)
    assert int(tstate.count) == int(jstate.count) == 3
    assert tstate.count.dtype == torch.int32
    for k, t, m, v in zip(sorted(params), tp, tstate.m, tstate.v):
        assert t.dtype == tdt
        if case == "bf16":
            np.testing.assert_array_equal(
                t.float().numpy(), np.asarray(jp[k], np.float32))
        else:
            _close(t, jp[k], 1e-6)
        _close(m, jstate.m[k], 1e-6)
        _close(v, jstate.v[k], 1e-6)


def test_cosine_schedule_matches_reference():
    jlr = j_adamw.cosine_schedule(2e-3, 10, 100, floor=0.1)
    tlr = adamw.cosine_schedule(2e-3, 10, 100, floor=0.1)
    for c in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        got = tlr(torch.tensor(c, dtype=torch.int32))
        assert got.dtype == torch.float32
        _close(got, jlr(jnp.asarray(c, jnp.int32)), 1e-9)
    assert float(tlr(torch.tensor(100))) == pytest.approx(2e-4, rel=1e-5)


def test_global_norm_matches_reference():
    tree = _tree(np.random.default_rng(1))
    _close(adamw.global_norm(_tensors(tree)),
           j_adamw.global_norm({k: jnp.asarray(v) for k, v in tree.items()}),
           1e-6)
    assert float(adamw.global_norm([torch.tensor([3.0]),
                                    torch.tensor([4.0])])) == 5.0


def test_adamw_update_makes_no_host_sync_values():
    """The metrics stay 0-d tensors on the parameters' device; the update
    is in place and leaves autograd out."""
    p = [torch.nn.Parameter(torch.ones(3))]
    opt = adamw.AdamW(learning_rate=0.1)
    state = opt.init(p)
    before = p[0].data_ptr()
    metrics = opt.update([torch.full((3,), 0.5)], state, p)
    assert p[0].data_ptr() == before and p[0].grad is None
    assert set(metrics) == {"grad_norm", "lr"}
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0
               for v in metrics.values())
    with pytest.raises(ValueError, match="gradients"):
        opt.update([], state, p)


# ---------------------------------------------------------------- compression

def test_compress_equals_reference_bit_for_bit():
    """q equal exactly (round half to even in both), scale and residual
    within fp32 rounding, over three error-feedback steps."""
    rng = np.random.default_rng(2)
    g = rng.standard_normal(300).astype(np.float32)
    g[:4] = [0.5, -0.5, 1.5, 2.5]  # halves: ties to even
    jr, tr = jnp.zeros(300, jnp.float32), torch.zeros(300)
    for _ in range(3):
        jq, js, jr = j_compression.compress(jnp.asarray(g), jr)
        tq, ts, tr = compression.compress(torch.from_numpy(g), tr)
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        _close(ts, js, 1e-7)
        _close(tr, jr, 1e-6)
        _close(compression.decompress(tq, ts),
               j_compression.decompress(jq, js), 1e-6)
    np.testing.assert_array_equal(torch.round(torch.tensor(
        [0.5, 1.5, 2.5, -0.5])).numpy(), [0.0, 2.0, 2.0, -0.0])


def test_compress_tree_error_feedback_matches_reference():
    rng = np.random.default_rng(3)
    tree = _tree(rng)
    jstate = j_compression.init_ef({k: jnp.asarray(v)
                                    for k, v in tree.items()})
    tstate = compression.init_ef(_tensors(tree))
    total = [torch.zeros_like(t) for t in _tensors(tree)]
    for _ in range(40):
        (jq, js), jstate = j_compression.compress_tree(
            {k: jnp.asarray(v) for k, v in tree.items()}, jstate)
        (tq, ts), tstate = compression.compress_tree(_tensors(tree), tstate)
        for k, q in zip(sorted(tree), tq):
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq[k]))
        for acc, d in zip(total, compression.decompress_tree(tq, ts)):
            acc.add_(d)
    for k, r in zip(sorted(tree), tstate.residual):
        _close(r, jstate.residual[k], 1e-5)
    # error feedback: the mean of the decompressed steps tends to g
    for acc, g, s in zip(total, _tensors(tree), ts):
        assert float((acc / 40 - g).abs().max()) <= float(s) / 2


def test_allreduce_compressed_is_the_ef_mean_over_a_mesh_axis():
    """Over the 3 positions of a CPU ``("pod",)`` mesh: each position
    gets sum(q) * mean(scale) / n of the reference's ``compress_tree``
    payloads, and its own new residual."""
    from repro_torch.runtime.stap_pipeline import DeviceMesh, _grid

    rng = np.random.default_rng(7)
    trees = [[rng.standard_normal((6, 5)).astype(np.float32) * (i + 1)]
             for i in range(3)]
    mesh = DeviceMesh(_grid([torch.device("cpu")] * 3, (3,)), ("pod",))
    states = [compression.init_ef(_tensors({"g": g[0]})) for g in trees]
    means, new_states = compression.allreduce_compressed(
        [_tensors({"g": g[0]}) for g in trees], states, mesh, "pod")
    packed = [j_compression.compress_tree(
        [jnp.asarray(g[0])], j_compression.init_ef([jnp.asarray(g[0])]))[0]
        for g in trees]
    qs = [np.asarray(q[0], np.int32) for q, _ in packed]
    js = [s for _, s in packed]
    scale = np.float32(sum(np.float32(s[0]) for s in js)) / np.float32(3)
    want = np.sum(qs, axis=0).astype(np.float32) * scale / np.float32(3)
    assert len(means) == len(new_states) == 3
    for m in means:
        _close(m[0], want, 1e-6)
    for st, g, q, s in zip(new_states, trees, qs, js):
        _close(st.residual[0], g[0] - q * np.float32(s[0]), 1e-6)


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("kw", [dict(vocab=97, seq_len=32, global_batch=8,
                                     seed=3),
                                dict(vocab=50, seq_len=8, global_batch=8,
                                     seed=1, n_shards=2, shard=1)])
def test_synthetic_lm_equals_reference(kw):
    ds, jds = SyntheticLM(**kw), JSyntheticLM(**kw)
    np.testing.assert_array_equal(ds.perm, jds.perm)
    for step in (0, 5):
        b, jb = ds.batch_at(step), jds.batch_at(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(b[k], jb[k])
    np.testing.assert_array_equal(ds.batch_at(0)["labels"][:, :-1],
                                  ds.batch_at(0)["tokens"][:, 1:])


def test_prefetcher_yields_reference_batches_in_order():
    ds = SyntheticLM(vocab=50, seq_len=8, global_batch=2, seed=1)
    jds = JSyntheticLM(vocab=50, seq_len=8, global_batch=2, seed=1)
    pf, jpf = Prefetcher(iter(ds), depth=2), JPrefetcher(iter(jds), depth=2)
    try:
        for _ in range(3):
            np.testing.assert_array_equal(next(pf)["tokens"],
                                          next(jpf)["tokens"])
    finally:
        pf.close()
        jpf.close()


# ---------------------------------------------------------------- checkpoint
# mirrors of tests/test_runtime.py's checkpoint tests, on tensors

def _ck_tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((4, 4), generator=g),
            "opt": {"m": torch.ones((3,)),
                    "count": torch.tensor(7, dtype=torch.int32)}}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _ck_tree(0)
    ck.save(10, t)
    like = _zeros_like(t)
    step, restored = ck.restore(like)
    assert step == 10 and restored is like
    torch.testing.assert_close(restored["w"], t["w"], rtol=0, atol=0)
    assert int(restored["opt"]["count"]) == 7
    assert restored["opt"]["count"].dtype == torch.int32


def test_checkpoint_layout_matches_reference(tmp_path):
    """The reference's checkpoint of the same values: the same files, the
    same leaf order (dict keys sorted), shapes, dtypes and md5s."""
    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer

    t = _ck_tree(1)
    Checkpointer(str(tmp_path / "port")).save(3, t)
    jt = {"w": jnp.asarray(t["w"].numpy()),
          "opt": {"m": jnp.asarray(t["opt"]["m"].numpy()),
                  "count": jnp.asarray(7, jnp.int32)}}
    JCheckpointer(str(tmp_path / "ref")).save(3, jt)
    d, jd = tmp_path / "port" / "step_3", tmp_path / "ref" / "step_3"
    assert sorted(os.listdir(d)) == sorted(os.listdir(jd))
    m = json.loads((d / "manifest.json").read_text())
    jm = json.loads((jd / "manifest.json").read_text())
    assert m["step"] == jm["step"] and m["leaves"] == jm["leaves"]


def test_checkpoint_async_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_n=2)
    for s in (1, 2, 3, 4):
        ck.save_async(s, _ck_tree(s))
    ck.wait()
    assert ck.committed_steps() == [3, 4]


def test_checkpoint_async_copies_before_returning(tmp_path):
    """save_async snapshots the values it was given: changing the tensors
    right after it returns does not reach the disk."""
    ck = Checkpointer(str(tmp_path))
    t = _ck_tree(0)
    want = t["w"].clone()
    ck.save_async(1, t)
    t["w"].add_(1.0)
    ck.wait()
    _, restored = ck.restore(_zeros_like(t))
    torch.testing.assert_close(restored["w"], want, rtol=0, atol=0)


def test_checkpoint_ignores_uncommitted(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _ck_tree(1))
    # simulate a crash mid-save: directory without COMMIT
    os.makedirs(tmp_path / "step_2")
    with open(tmp_path / "step_2" / "manifest.json", "w") as f:
        f.write("{}")
    assert ck.committed_steps() == [1]
    step, _ = ck.restore(_ck_tree(0))
    assert step == 1


def test_checkpoint_detects_corruption(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _ck_tree(0)
    ck.save(5, t)
    leaf = tmp_path / "step_5" / "leaf_0.npy"
    arr = np.load(leaf)
    np.save(leaf, arr + 1)
    with pytest.raises(ValueError, match="corrupted"):
        ck.restore(t)


def test_checkpoint_module_adamw_state_and_bf16(tmp_path):
    """A (module, AdamWState) tree with a bf16 parameter restores bit for
    bit into fresh tensors; a tree of another size is refused."""
    mod = torch.nn.Linear(3, 2).to(torch.bfloat16)
    opt = adamw.AdamW()
    state = opt.init(mod)
    opt.update([torch.ones_like(p) for p in mod.parameters()], state, mod)
    ck = Checkpointer(str(tmp_path))
    ck.save(2, (mod, state))
    mod2 = torch.nn.Linear(3, 2).to(torch.bfloat16)
    state2 = opt.init(mod2)
    step, _ = ck.restore((mod2, state2))
    assert step == 2 and int(state2.count) == 1
    for a, b in zip(list(mod.parameters()) + state.m + state.v,
                    list(mod2.parameters()) + state2.m + state2.v):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="structure"):
        ck.restore(mod2)


# ---------------------------------------------------------------- policy

@pytest.mark.parametrize("args", [(1e9, 8, 1), (1e9, 6, 3), (5e9, 64, 4),
                                  (5e9, 12, 1), (5e9, 1, 1), (1e9, 2, 2)])
def test_microbatch_policy_matches_reference(args):
    assert microbatch_policy(*args) == j_microbatch_policy(*args)
