"""``Runtime.remat`` in the port: each layer of every stack recomputed in the
backward, on the CPU, for a dense, an MoE, an SSM, a hybrid and an enc-dec
model (the reduced llama3-8b, mixtral-8x22b, rwkv6-7b, zamba2-2.7b and
seamless-m4t-medium), in float32 (weights and batches: ``_model``).

- The loss and every gradient leaf under ``"full"``, ``"dots"`` and
  ``"attn"`` (which the reference's ``_remat`` takes as ``"full"``) are the
  ones ``"none"`` gives, bit for bit: recomputing runs the same operations
  on the same inputs.
- The kernels' plain versions run again in the backward, once for each
  call inside a wrapped layer: what the hybrid's shared block and the final
  norms call is not wrapped, as in the reference.
- The bytes kept for the backward are ordered full < dots < none. They are
  what ``torch.autograd.graph.saved_tensors_hooks`` sees outside the
  recomputed layers, plus, under ``"dots"``, the products' results that its
  policy keeps (those bypass the hooks, so the test counts them as the
  policy marks them).
- Against the reference's ``jax.value_and_grad`` under ``"full"`` and
  ``"dots"`` (the port's flash route, the reference's plain route), at the
  float32 bounds of ``tests/test_torch_train.py`` and
  ``tests/test_torch_train_ssm.py``: within 1e-5 of each result's scale,
  3e-5 for the hybrid, and the SSM with both packages' WKV in the Pallas
  kernel's function (every product float32), as that file holds it.
"""
from __future__ import annotations

import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import Runtime as JRuntime
from repro.models import build_param_specs as j_specs
from repro.models import init_params as j_init_params
from repro.kernels.rwkv6_wkv.ops import wkv_scan as j_wkv_scan
from repro.models import loss_fn as j_loss_fn
from repro.models import rwkv6 as J6
from repro_torch import configs as PC
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import counts
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models import Runtime as PRuntime
from repro_torch.models import loss_fn as p_loss_fn
from repro_torch.models import model as PM
from repro_torch.models import rwkv6 as P6
from repro_torch.models.params import tree_leaves, tree_map

CPU = torch.device("cpu")
F32 = 1e-5
HYBRID_F32 = 3e-5
ARCHS = {"dense": "llama3-8b", "moe": "mixtral-8x22b", "ssm": "rwkv6-7b",
         "hybrid": "zamba2-2.7b", "encdec": "seamless-m4t-medium"}
REMATS = ["full", "dots", "attn"]
B, S, SE = 2, 32, 48
RT_KW = dict(param_dtype="float32", compute_dtype="float32", attn_chunk=16, q_block=16,
             kv_block=16, act_shard=False)
FORWARD = ("flash_attn_fwd", "moe_gmm", "rmsnorm_fwd", "rwkv6_wkv", "mamba2_ssd")
BACKWARD = ("flash_attn_dq", "flash_attn_dkv", "moe_gmm_bwd", "rmsnorm_bwd", "rwkv6_wkv_bwd",
            "mamba2_ssd_bwd")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _np_tree(specs, seed: int):
    """numpy weights for a reference spec tree, ``tests/test_torch_train_ssm.py``'s
    recipe: ones where the spec says, a normal draw elsewhere (zeros-initialised
    leaves at scale 0.5) times 1/sqrt(fan_in) (``scaled``) or 0.02."""
    rng = np.random.default_rng(seed)

    def one(s):
        if s.init == "ones":
            return np.ones(s.shape, np.float32)
        if s.init == "zeros":
            return (rng.standard_normal(s.shape) * 0.5).astype(np.float32)
        fan_in = s.shape[s.fan_in_axis] if len(s.shape) >= 2 else s.shape[-1]
        scale = 1.0 / np.sqrt(fan_in) if s.init == "scaled" else 0.02
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return jax.tree.map(one, specs, is_leaf=lambda s: hasattr(s, "fan_in_axis"))


@functools.cache
def _model(family: str):
    """(reference cfg, port cfg, reference params, numpy batch): the SSM and
    hybrid weights and batch as ``tests/test_torch_train_ssm.py`` draws them
    (its recipe, the hybrid's ``A_log`` at 0, 2 x 64 tokens from seed 17), the
    others' the reference's ``init_params(..., PRNGKey(0))`` and 2 x 32 tokens
    from seed 1 (with 2 x 48 encoder frames)."""
    jcfg = RC.reduced(RC.get_arch(ARCHS[family]))
    specs = j_specs(jcfg, JRuntime(**RT_KW))
    if family in ("ssm", "hybrid"):
        tree = _np_tree(specs, seed=0)
        if family == "hybrid":
            tree["blocks"]["mamba"]["A_log"] = np.zeros_like(tree["blocks"]["mamba"]["A_log"])
        jp = jax.tree.map(jnp.asarray, tree)
        toks = np.random.default_rng(17).integers(2, jcfg.vocab, (B, 65)).astype(np.int32)
    else:
        jp = j_init_params(specs, jax.random.PRNGKey(0))
        toks = np.random.default_rng(1).integers(2, jcfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if family == "encdec":
        enc = np.random.default_rng(2).standard_normal((B, SE, jcfg.d_model))
        batch["enc_embeds"] = enc.astype(np.float32)
    return jcfg, PC.reduced(PC.get_arch(ARCHS[family])), jp, batch


@contextlib.contextmanager
def _float32_wkv(on: bool):
    """Both packages' ``_wkv_chunked`` in the Pallas kernel's function, as
    ``tests/test_torch_train_ssm.py`` patches it: the reference's
    ``wkv_scan``, the port's K12 with K12b."""
    if not on:
        yield
        return

    def ref(r, k, v, w, u, chunk):
        B_, S_, H, K = r.shape

        def bh(t):
            return t.transpose(0, 2, 1, 3).reshape(B_ * H, S_, K)

        u_bh = jnp.broadcast_to(u[None], (B_, H, K)).reshape(B_ * H, K)
        y = j_wkv_scan(bh(r), bh(k), bh(v), bh(w), u_bh, chunk=chunk, interpret=True)
        return y.reshape(B_, H, S_, K).transpose(0, 2, 1, 3)

    def port(r, k, v, w, u, chunk):
        return wkv_ops._wkv(r, k, v, w, u[None], chunk, False)[0]

    with mock.patch.object(J6, "_wkv_chunked", ref), mock.patch.object(P6, "_wkv_chunked", port):
        yield


@functools.cache
def _port_grads(family: str, remat: str, f32_wkv: bool = False):
    """(loss, gradient leaves, plain-call counts) of the port's ``loss_fn`` on
    the flash route (read, never written, by the tests); ``f32_wkv``: under
    ``_float32_wkv``."""
    _, pcfg, jp, batch = _model(family)
    params = tree_map(lambda p: p.requires_grad_(True),
                      lm_params_from_numpy(jax.tree.map(np.asarray, jp), CPU))
    leaves = tree_leaves(params)
    rt = PRuntime(**RT_KW, remat=remat, attn_impl="flash")
    counts.reset()
    with _float32_wkv(f32_wkv):
        loss = p_loss_fn(params, pcfg, rt, {k: torch.from_numpy(v) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads, dict(counts.PLAIN_CALLS)


def _unwrapped(family: str, cfg) -> dict:
    """Plain calls of the forward kernels outside the wrapped layers: the
    final norm (and the encoder's), the hybrid's shared blocks."""
    out = {"rmsnorm_fwd": 2 if family == "encdec" else 1}
    if family == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        out["rmsnorm_fwd"] += 2 * groups
        out["flash_attn_fwd"] = groups
    return out


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("family", sorted(ARCHS))
def test_remat_gives_the_gradients_of_none_bit_for_bit(family, remat):
    loss0, grads0, calls0 = _port_grads(family, "none")
    loss, grads, calls = _port_grads(family, remat)
    assert torch.equal(loss, loss0)
    for g, g0 in zip(grads, grads0):
        assert torch.equal(g, g0)
    # each forward kernel runs again for every call inside a wrapped layer;
    # the backward kernels as often as without remat
    unwrapped = _unwrapped(family, _model(family)[1])
    for k in FORWARD:
        assert calls[k] == 2 * calls0[k] - unwrapped.get(k, 0), (k, calls[k], calls0[k])
    for k in BACKWARD:
        assert calls[k] == calls0[k], k
    assert calls0[{"dense": "flash_attn_fwd", "moe": "moe_gmm", "ssm": "rwkv6_wkv",
                   "hybrid": "mamba2_ssd", "encdec": "flash_attn_fwd"}[family]] > 0


def _saved_bytes(family: str, remat: str, monkeypatch) -> int:
    """Bytes kept for the backward by one forward of ``loss_fn``."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    policy = PM._save_dots

    def counted(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if decision == PM.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
            out = op(*meta, **kwargs)
            total[0] += out.numel() * out.element_size()
        return decision

    monkeypatch.setattr(PM, "_save_dots", counted)
    _, pcfg, jp, batch = _model(family)
    params = tree_map(lambda p: p.requires_grad_(True),
                      lm_params_from_numpy(jax.tree.map(np.asarray, jp), CPU))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = p_loss_fn(params, pcfg, PRuntime(**RT_KW, remat=remat, attn_impl="flash"),
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    assert loss.requires_grad
    return total[0]


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_remat_keeps_fewer_bytes_for_the_backward(family, monkeypatch):
    n = {r: _saved_bytes(family, r, monkeypatch) for r in ("none", "dots", "full")}
    assert n["full"] < n["dots"] < n["none"], n


@functools.cache
def _ref_grads(family: str, remat: str):
    jcfg, _, jp, batch = _model(family)
    jrt = JRuntime(**RT_KW, remat=remat, attn_impl="xla")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with _float32_wkv(family == "ssm"):
        loss, grads = jax.jit(jax.value_and_grad(lambda p: j_loss_fn(p, jcfg, jrt, jb)))(jp)
    return float(loss), [_np(g) for g in jax.tree.leaves(grads)]


# "attn" is not compiled again: the reference's _remat takes it as "full"
# (its else branch), and the port's "attn" gives "full"'s gradients bit for
# bit (the test above)
@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("family", sorted(ARCHS))
def test_remat_matches_the_reference(family, remat):
    # the port's flash route against the reference's plain route, which
    # agree at these bounds without remat (tests/test_torch_train.py,
    # tests/test_torch_train_ssm.py)
    loss, grads, _ = _port_grads(family, remat, family == "ssm")
    jloss, jgrads = _ref_grads(family, remat)
    tol = HYBRID_F32 if family == "hybrid" else F32
    assert abs(float(loss) - jloss) <= tol * jloss
    assert len(grads) == len(jgrads)
    for got, want in zip(grads, jgrads):
        got = _np(got)
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= tol * scale
