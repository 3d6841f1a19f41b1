"""The port's LM training path against the JAX package on the CPU, on
parameters converted from JAX and numpy-made batches, fp32 throughout:
``chunked_cross_entropy``; ``train_loss`` and the gradient of every
parameter for the six smoke families (dense, MoE with drops, Mamba-2,
the Jamba hybrid, M-RoPE, encoder-decoder); the MoE layer's gradients
with drops; ``make_train_step`` at one and two microbatches over two
steps (params and optimizer state leaf by leaf); ``train()`` end to end
(the loss falls, a restart is exact, no GPU means an error); per-layer
checkpointing changing no value; and the reference's SSD-gradient fault,
reproduced at the same entries."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.launch.train_step import make_train_step as j_make_train_step
from repro.models import mamba as j_mamba
from repro.models import moe as j_moe
from repro.models import transformer as j_transformer
from repro.models.api import build_model as j_build_model
from repro.optim.adamw import AdamW as JAdamW
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.launch.train import train
from repro_torch.launch.train_step import make_train_step
from repro_torch.models import mamba, moe, transformer
from repro_torch.models.api import build_model
from repro_torch.optim.adamw import AdamW

ARCHS = ["llama3.2-1b", "olmoe-1b-7b", "mamba2-1.3b", "jamba-1.5-large-398b",
         "qwen2-vl-2b", "seamless-m4t-large-v2"]
B, S = 2, 24
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread for this module: ``train()`` on a smoke config
    is many tiny operations, and with torch's default thread pool on a
    host that parallel test workers load, each one waits for descheduled
    threads (40 steps took 206 s under six workers against 1.2 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def np_batch(cfg, rng, b=B, s=S):
    """tokens, labels (the first three of row 0 padding, -1), and
    ``positions`` (M-RoPE) or ``enc_embeds`` (encoder-decoder)."""
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    batch["labels"][0, :3] = -1
    if cfg.is_enc_dec:
        batch["enc_embeds"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    if cfg.mrope_sections is not None:
        batch["positions"] = rng.integers(0, 30, (b, s, 3)).astype(np.int32)
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def host(tree):
    """The tree's arrays as writable numpy copies."""
    return jax.tree.map(np.array, tree)


# ---------------------------------------------------------------- the loss

@pytest.mark.parametrize("arch", ["llama3.2-1b", "internlm2-1.8b"])
def test_chunked_cross_entropy_matches_reference(arch):
    """Tied (llama) and untied (internlm2) heads, -1 labels, chunk 8 over
    S = 20 (a short last chunk); the value and its gradients w.r.t. the
    activations and the head."""
    cfg = get_smoke(arch)
    jp = host(j_transformer.init_decoder_params(j_get_smoke(arch),
                                                jax.random.PRNGKey(1),
                                                jnp.float32))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (2, 20)).astype(np.int32)
    labels[1, 5:9] = -1
    head = "embed" if cfg.tie_embeddings else "lm_head"

    def j_loss(xx, w):
        p = dict(jp, **{head: w})
        return j_transformer.chunked_cross_entropy(p, xx, jnp.asarray(labels),
                                                   j_get_smoke(arch), chunk=8)

    jl, (jgx, jgw) = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(jp[head]))
    params = convert.lm_params_from_numpy(jp, cfg)
    tx = torch.from_numpy(x).requires_grad_()
    loss = transformer.chunked_cross_entropy(params, tx,
                                             torch.from_numpy(labels), cfg,
                                             chunk=8)
    gx, gw = torch.autograd.grad(loss, [tx, getattr(params, head)])
    close(loss.detach(), jl)
    close(gx, jgx)
    close(gw, jgw)


@pytest.fixture(scope="module", params=ARCHS)
def loss_case(request):
    """One family's smoke config: the reference's loss, aux and gradient
    tree (computed once), and the port's on the converted parameters."""
    arch = request.param
    jcfg, cfg = j_get_smoke(arch), get_smoke(arch)
    japi = j_build_model(jcfg, dtype=jnp.float32)
    jp = jax.jit(japi.init)(jax.random.PRNGKey(0))
    batch = np_batch(cfg, np.random.default_rng(0))
    (jl, jaux), jg = jax.jit(jax.value_and_grad(japi.train_loss,
                                                has_aux=True))(jp, batch)
    api = build_model(cfg, dtype=torch.float32, device="cpu")
    params = convert.lm_params_from_numpy(host(jp), cfg)
    loss, aux = api.train_loss(params, torch_batch(batch))
    grads = torch.autograd.grad(loss, list(params.parameters()))
    return dict(arch=arch, want=(jl, host(jaux), host(jg)),
                got=(loss.detach(), {k: v.detach() for k, v in aux.items()},
                     convert.lm_params_to_numpy(params, cfg, grads)))


def test_train_loss_matches_reference(loss_case):
    (jl, jaux), (loss, aux) = loss_case["want"][:2], loss_case["got"][:2]
    close(loss, jl)
    assert set(aux) == set(jaux)
    for name, value in jaux.items():
        close(aux[name], value)


def test_train_loss_gradient_of_every_parameter_matches_reference(loss_case):
    jg, grads = loss_case["want"][2], loss_case["got"][2]
    assert jax.tree.structure(jg) == jax.tree.structure(grads)
    paths = jax.tree_util.tree_flatten_with_path(jg)[0]
    for (path, want), got in zip(paths, jax.tree.leaves(grads)):
        assert got.shape == want.shape, path
        np.testing.assert_allclose(got, want, err_msg=str(path), **TOL)
        assert np.isfinite(got).all(), path


def test_moe_gradients_with_drops_match_reference():
    """Router and experts' gradients (and the input's) through the local
    MoE layer, at a capacity that drops assignments (asserted)."""
    cfg = get_smoke("olmoe-1b-7b")
    jp = host(j_moe.init_moe(jax.random.PRNGKey(3), cfg.d_model, cfg.moe,
                             jnp.float32))
    x = np.random.default_rng(3).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    t = 2 * 24
    c = moe.capacity(t, cfg.moe.n_experts, cfg.moe.top_k,
                     cfg.moe.capacity_factor)
    _, _, pos, _ = moe._route(torch.from_numpy(x).reshape(t, -1),
                              torch.from_numpy(jp["router"]),
                              cfg.moe.n_experts, cfg.moe.top_k)
    assert int((pos >= c).sum()) > 0, "no assignment dropped"

    def j_f(p, xx):
        y, aux = j_moe.moe_sublayer(p, xx, cfg.moe, impl="local")
        return (jnp.sum(y * jnp.cos(xx)) + aux["load_balance_loss"]
                + aux["router_z_loss"])

    jgp, jgx = jax.jit(jax.grad(j_f, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_sublayer(tp, tx, cfg.moe)
    f = (torch.sum(y * torch.cos(tx)) + aux["load_balance_loss"]
         + aux["router_z_loss"])
    grads = torch.autograd.grad(f, [tp[k] for k in sorted(tp)] + [tx])
    for k, g in zip(sorted(tp), grads):
        close(g, jgp[k], dict(rtol=1e-4, atol=1e-5))
    close(grads[-1], jgx, dict(rtol=1e-4, atol=1e-5))


# ---------------------------------------------------------------- the step

@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_matches_reference_over_two_steps(microbatches):
    """llama smoke, batch 4: two steps from the same params and batches;
    loss and grad_norm each step, then every parameter and AdamWState
    leaf (m, v, count)."""
    arch = "llama3.2-1b"
    jcfg, cfg = j_get_smoke(arch), get_smoke(arch)
    japi = j_build_model(jcfg, dtype=jnp.float32)
    jp = japi.init(jax.random.PRNGKey(2))
    jopt = JAdamW(learning_rate=3e-3, weight_decay=0.01)
    jstate = jopt.init(jp)
    jstep = jax.jit(j_make_train_step(japi, jopt, microbatches))
    api = build_model(cfg, dtype=torch.float32, device="cpu")
    params = convert.lm_params_from_numpy(host(jp), cfg)
    opt = AdamW(learning_rate=3e-3, weight_decay=0.01)
    state = opt.init(params)
    step = make_train_step(api, opt, microbatches)
    rng = np.random.default_rng(4)
    for _ in range(2):
        batch = np_batch(cfg, rng, b=4, s=16)
        if microbatches > 1:
            batch = {k: v.reshape(microbatches, 4 // microbatches,
                                  *v.shape[1:]) for k, v in batch.items()}
        jp, jstate, jm = jstep(jp, jstate, batch)
        m = step(params, state, torch_batch(batch))
        for name in ("loss", "grad_norm", "lr"):
            close(m[name], jm[name])
    jp, jstate = host(jp), host(jstate)
    got = convert.lm_params_to_numpy(params, cfg)
    gm, gv, count = convert.adamw_state_to_numpy(state, params, cfg)
    assert int(count) == int(jstate.count) == 2
    for want_tree, got_tree in ((jp, got), (jstate.m, gm), (jstate.v, gv)):
        assert jax.tree.structure(want_tree) == jax.tree.structure(got_tree)
        for want, have in zip(jax.tree.leaves(want_tree),
                              jax.tree.leaves(got_tree)):
            close(have, want)


def test_adamw_state_converts_both_ways():
    """A reference AdamWState through adamw_state_from_numpy and back is
    the same tree."""
    arch = "jamba-1.5-large-398b"
    cfg = get_smoke(arch)
    shapes = jax.eval_shape(lambda: j_transformer.init_decoder_params(
        j_get_smoke(arch), jax.random.PRNGKey(5), jnp.float32))
    jp = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    rng = np.random.default_rng(5)
    jm = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), jp)
    jv = jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), jp)
    state = convert.adamw_state_from_numpy(
        type("S", (), dict(m=jm, v=jv, count=np.int32(9)))(), cfg)
    params = convert.lm_params_from_numpy(jp, cfg)
    assert [m.shape for m in state.m] == [p.shape for p in
                                          params.parameters()]
    m, v, count = convert.adamw_state_to_numpy(state, params, cfg)
    assert int(count) == 9 and state.count.dtype == torch.int32
    for want, got in ((jm, m), (jv, v)):
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_array_equal(a, b)


def test_remat_changes_no_value():
    """Per-layer checkpointing (with the per-chunk ones inside) recomputes;
    the stack's output and every gradient equal bit for bit to the run
    that keeps every activation."""
    cfg = get_smoke("jamba-1.5-large-398b")
    params = build_model(cfg, dtype=torch.float32, device="cpu").init(
        torch.Generator().manual_seed(0))
    batch = torch_batch(np_batch(cfg, np.random.default_rng(6)))
    positions = torch.arange(S)[None].expand(B, S)
    out = []
    for remat in (True, False):
        x = transformer.embed_tokens(params, batch["tokens"], cfg)
        x, _, aux = transformer.decoder_stack(
            params, x, cfg, positions, attn_impl="chunked",
            ssd_impl="chunked", remat=remat)
        loss = (transformer.chunked_cross_entropy(params, x, batch["labels"],
                                                  cfg)
                + aux["load_balance_loss"] + aux["router_z_loss"])
        out.append([loss] + list(torch.autograd.grad(
            loss, list(params.parameters()))))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------- train()

def test_train_reduces_loss_on_the_cpu():
    _, losses = train("llama3.2-1b", smoke=True, steps=40, batch=8, seq=64,
                      lr=3e-3, log_every=1000, device="cpu")
    assert len(losses) == 40 and np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_train_restart_from_checkpoint_is_exact(tmp_path):
    """An interrupted run (4 of 8 steps, the schedule shaped for 8) then
    resumed from its step-4 checkpoint gives the uninterrupted run's
    losses and parameters, bit for bit."""
    kw = dict(smoke=True, batch=4, seq=32, ckpt_every=4, log_every=1000,
              microbatches=2, device="cpu")
    full_p, full = train("llama3.2-1b", steps=8, ckpt_dir=str(tmp_path / "a"),
                         **kw)
    train("llama3.2-1b", steps=4, ckpt_dir=str(tmp_path / "b"),
          total_steps=8, **kw)
    res_p, resumed = train("llama3.2-1b", steps=8,
                           ckpt_dir=str(tmp_path / "b"), **kw)
    assert resumed == full[4:]
    for a, b in zip(full_p.parameters(), res_p.parameters()):
        assert torch.equal(a, b)


def test_train_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        train("llama3.2-1b", steps=1)


# ---------------------------------------------------------------- SSD fault

@pytest.mark.parametrize("a_step", [-0.1, -0.8])
def test_ssd_gradient_fault_matches_reference(a_step):
    """The reference's intra-chunk mask takes exp before it masks
    (``mamba.py:90``): at chunk 256 the gradient w.r.t. the log decay is
    finite for a = -0.1 a step and not for a = -0.8. The port keeps the
    formulation: its gradients are the reference's where finite, and
    non-finite at the same entries, so a fix goes into both at once."""
    bsz, t, h, p, g, n, chunk = 1, 256, 2, 4, 1, 4, 256
    rng = np.random.default_rng(7)
    x = rng.standard_normal((bsz, t, h, p)).astype(np.float32)
    a = (a_step * (1 + 0.1 * rng.random((bsz, t, h)))).astype(np.float32)
    b = rng.standard_normal((bsz, t, g, n)).astype(np.float32)
    c = rng.standard_normal((bsz, t, g, n)).astype(np.float32)

    def j_f(aa, xx):
        y, st = j_mamba.ssd_chunked(xx, aa, jnp.asarray(b), jnp.asarray(c),
                                    n_groups=g, chunk=chunk)
        return jnp.sum(y) + jnp.sum(st)

    jga, jgx = host(jax.grad(j_f, argnums=(0, 1))(jnp.asarray(a),
                                                  jnp.asarray(x)))
    ta = torch.from_numpy(a).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    y, st = mamba.ssd_chunked(tx, ta, torch.from_numpy(b),
                              torch.from_numpy(c), n_groups=g, chunk=chunk)
    ga, gx = torch.autograd.grad(y.sum() + st.sum(), [ta, tx])
    for got, want in ((ga.numpy(), jga), (gx.numpy(), jgx)):
        finite = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), finite)
        np.testing.assert_allclose(got[finite], want[finite], rtol=1e-4,
                                   atol=1e-3)
    assert np.isfinite(jga).all() == (a_step == -0.1)
