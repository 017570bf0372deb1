"""Shapley-value attribution of knob values (paper §5.1).

The paper uses SHAP to decide, per configuration in the promising set,
whether each knob's *value* helps (negative attribution on latency) or
hurts. Only the sign and rough magnitude matter downstream (Eq. 3).

We compute *interventional* Shapley values of a surrogate model f with a
background dataset B:

    phi_j(x) = E_pi [ f(x_{S u j}) - f(x_S) ],   S = features before j in pi

estimated with antithetic permutation sampling (each sampled permutation is
paired with its reverse, which cuts variance substantially; an odd
``n_permutations`` runs (n-1)//2 pairs plus one unpaired forward draw, so
exactly n permutation chains are evaluated either way). For small
dimensionality an exact enumeration over all permutations is available and
used by the tests to bound the Monte-Carlo error.

Two equivalent evaluation paths:

``backend="batched"`` (default) evaluates whole
(permutations x (d+1) prefix masks x background) blocks at once: through
the bitvector chain kernel (``kernels.forest_eval.chain``, kernel K3 on the
surrogate's device) when the surrogate behind f is supplied via ``model=``
and admits a chain plan, else by materializing the
composite tensor and pushing it through f in a few large chunked calls.
``backend="loop"`` is the legacy per-chain reference (host numpy, one call
of f per chain, as in the reference). All paths consume
the same pre-drawn permutation matrix and replay the identical
accumulation order, so their attributions are bit-identical; the batch
explainer :func:`shapley_values_batch` extends the same contract across
many explained configs (one fused pass instead of one call per config).

Additivity (sum_j phi_j = f(x) - E_B[f]) holds exactly in expectation and
is enforced by a final residual correction distributed *proportionally* to
|phi_j| (uniform only as a fallback when every attribution is exactly
zero), so the downstream sign logic sees an exactly-additive decomposition
and near-zero-phi knobs are not polluted with spurious residual mass.
"""

from __future__ import annotations

from itertools import permutations
from typing import Callable, Optional

import numpy as np

from .. import obs as _obs

__all__ = [
    "draw_permutations",
    "shapley_values",
    "shapley_values_batch",
    "shapley_values_exact",
]

# rows-per-model-call bound for the batched plane: whole permutation chains
# only, so chunk boundaries never split a (d+1)*nb block and per-row results
# are unchanged by the chunking
_MAX_EVAL_ROWS = 262_144


def draw_permutations(
    d: int, n_permutations: int, rng: np.random.Generator
) -> np.ndarray:
    """Antithetic permutation matrix, shape (n_permutations, d).

    Rows 2i / 2i+1 hold the i-th draw and its reverse (the order the legacy
    per-chain loop consumed them in); an odd count appends one unpaired
    forward draw. Both backends consume this matrix, which is what makes
    them bit-comparable.
    """
    if n_permutations < 1:
        raise ValueError("n_permutations must be >= 1")
    rows = []
    for _ in range(n_permutations // 2):
        perm = rng.permutation(d)
        rows.append(perm)
        rows.append(perm[::-1])
    if n_permutations % 2:
        rows.append(rng.permutation(d))
    return np.stack(rows)


def _prefix_masks(perm: np.ndarray) -> np.ndarray:
    """(d+1, d) boolean prefix-mask chain S_0 = {} ... S_d = all, along perm."""
    d = len(perm)
    masks = np.zeros((d + 1, d), dtype=bool)
    for k in range(1, d + 1):
        masks[k] = masks[k - 1]
        masks[k, perm[k - 1]] = True
    return masks


def _prefix_masks_batch(perms: np.ndarray) -> np.ndarray:
    """(P, d+1, d) prefix-mask chains for a whole permutation matrix.

    rank[p, j] = position of feature j in permutation p; the k-th prefix
    contains exactly the features with rank < k.
    """
    P, d = perms.shape
    rank = np.empty((P, d), dtype=np.int64)
    np.put_along_axis(rank, perms, np.broadcast_to(np.arange(d), (P, d)), axis=1)
    return rank[:, None, :] < np.arange(d + 1)[None, :, None]


def _eval_masked(
    f: Callable[[np.ndarray], np.ndarray],
    x: np.ndarray,
    background: np.ndarray,
    masks: np.ndarray,
) -> np.ndarray:
    """E_b[f(z)] where z takes x on mask==True and background rows elsewhere.

    masks: (m, d) boolean. Returns (m,) averaging over all background rows.
    """
    nb, d = background.shape
    m = len(masks)
    # build (m*nb, d) matrix
    Z = np.broadcast_to(background[None, :, :], (m, nb, d)).copy()
    Xb = np.broadcast_to(x[None, None, :], (m, nb, d))
    M = np.broadcast_to(masks[:, None, :], (m, nb, d))
    Z[M] = Xb[M]
    vals = f(Z.reshape(m * nb, d))
    return vals.reshape(m, nb).mean(axis=1)


def _chain_deltas_loop(
    f: Callable[[np.ndarray], np.ndarray],
    x: np.ndarray,
    background: np.ndarray,
    perms: np.ndarray,
) -> np.ndarray:
    """Per-permutation marginal contributions, one model call per chain.

    The pinned reference: returns (P, d) deltas in *permutation order*
    (row i, column k = contribution of feature perms[i, k]).
    """
    out = np.empty(perms.shape, dtype=float)
    for i, perm in enumerate(perms):
        vals = _eval_masked(f, x, background, _prefix_masks(perm))
        out[i] = vals[1:] - vals[:-1]
    return out


def _chain_deltas_batched(
    f: Callable[[np.ndarray], np.ndarray],
    X: np.ndarray,
    background: np.ndarray,
    perms: np.ndarray,
    max_eval_rows: int,
    model=None,
) -> np.ndarray:
    """Marginal contributions for many (config, permutation) chains at once.

    X: (n, d) configs to explain; perms: (n, P, d) per-config permutation
    matrices. Returns (n, P, d) deltas in permutation order, bit-identical
    to the per-chain loop.

    When ``model`` is a packed-forest surrogate the chains are evaluated by
    the bitvector chain kernel (``kernels.forest_eval.chain``, kernel K3 on
    the surrogate's device) — no composite tensor, ~1 word-AND per row
    instead of a gather descent.
    Otherwise (or when the kernel doesn't apply: a tree with > 64 leaves,
    d > 64) this builds the (chains x (d+1) prefixes x background)
    composite tensor and evaluates it through ``f`` in calls of at most
    ``max_eval_rows`` rows (never splitting a chain), so one forest pass
    covers many chains while peak memory stays bounded. Per-row model
    outputs and the per-chain background means are independent of how
    chains are grouped into calls, so all three paths agree bit-for-bit.
    """
    n, P, d = perms.shape
    nb = background.shape[0]
    rows_per_chain = (d + 1) * nb
    chains_per_call = max(1, max_eval_rows // rows_per_chain)
    # flatten (config, permutation) -> chain axis
    flat_perms = perms.reshape(n * P, d)
    x_of_chain = np.repeat(np.arange(n), P)
    vals = np.empty((n * P, d + 1), dtype=float)

    plan = None
    if model is not None:
        from ..kernels.forest_eval.chain import build_chain_plan_ex

        plan, _reason = build_chain_plan_ex(model, d)
    _obs.count(
        "shapley/chain_kernel" if plan is not None else "shapley/composite_fallback"
    )
    for a in range(0, n * P, chains_per_call):
        b = min(a + chains_per_call, n * P)
        if plan is not None:
            vals[a:b] = plan.eval_chains(
                X, background, flat_perms[a:b], x_of_chain[a:b]
            )
            continue
        masks = _prefix_masks_batch(flat_perms[a:b])          # (C, d+1, d)
        C = b - a
        M = np.broadcast_to(masks[:, :, None, :], (C, d + 1, nb, d))
        Z = np.broadcast_to(background[None, None, :, :], (C, d + 1, nb, d)).copy()
        Xb = np.broadcast_to(
            X[x_of_chain[a:b], None, None, :], (C, d + 1, nb, d)
        )
        Z[M] = Xb[M]
        out = f(Z.reshape(C * (d + 1) * nb, d))
        # same per-chain reduction as _eval_masked: mean over the background
        # rows of each (chain, prefix) block
        vals[a:b] = np.asarray(out).reshape(C, d + 1, nb).mean(axis=2)
    deltas = vals[:, 1:] - vals[:, :-1]
    return deltas.reshape(n, P, d)


def _reduce_chains(perms: np.ndarray, deltas: np.ndarray) -> np.ndarray:
    """phi from (P, d) permutation-order deltas, replaying the legacy
    accumulation: chains are added feature-wise in draw order, then divided
    by the chain count — the exact op sequence of the old per-chain
    ``phi[p] += vals[1:] - vals[:-1]`` loop."""
    P, d = perms.shape
    contrib = np.empty((P, d), dtype=float)
    rows = np.arange(P)[:, None]
    contrib[rows, perms] = deltas
    phi = np.zeros(d)
    for i in range(P):  # sequential adds preserve the loop's float order
        phi += contrib[i]
    phi /= P
    return phi


def _residual_correct(
    phi: np.ndarray,
    f: Callable[[np.ndarray], np.ndarray],
    x: np.ndarray,
    background: np.ndarray,
    fx: Optional[float] = None,
    f0: Optional[float] = None,
) -> np.ndarray:
    """Exact-additivity correction: distribute the (small) MC residual
    proportionally to |phi| so near-zero attributions stay near zero (a
    knob the model ignores keeps phi exactly 0.0); uniform fallback only
    when every phi is exactly zero."""
    if fx is None:
        fx = float(f(x[None, :])[0])
    if f0 is None:
        f0 = float(np.asarray(f(background)).mean())
    resid = (fx - f0) - phi.sum()
    mag = np.abs(phi)
    total = mag.sum()
    if total > 0:
        phi = phi + resid * (mag / total)
    else:
        phi = phi + resid / len(phi)
    return phi


def shapley_values(
    f: Callable[[np.ndarray], np.ndarray],
    x: np.ndarray,
    background: np.ndarray,
    n_permutations: int = 32,
    rng: Optional[np.random.Generator] = None,
    backend: str = "batched",
    perms: Optional[np.ndarray] = None,
    max_eval_rows: int = _MAX_EVAL_ROWS,
    model=None,
) -> np.ndarray:
    """Antithetic-permutation-sampled interventional Shapley values.

    f: vectorized model, maps (n, d) -> (n,).
    x: (d,) the point to explain. background: (nb, d).
    perms: optional pre-drawn (P, d) permutation matrix (overrides
    n_permutations/rng) — sharing it across backends makes them
    bit-comparable.
    model: optional forest object behind ``f``; lets the batched backend
    evaluate chains through the bitvector kernel (bit-identical, much
    faster) instead of the composite tensor. Ignored by ``backend="loop"``.
    """
    x = np.asarray(x, dtype=float)
    background = np.atleast_2d(np.asarray(background, dtype=float))
    d = len(x)
    if perms is None:
        rng = rng or np.random.default_rng(0)
        perms = draw_permutations(d, n_permutations, rng)
    else:
        perms = np.asarray(perms)
    if backend == "loop":
        deltas = _chain_deltas_loop(f, x, background, perms)
    elif backend == "batched":
        deltas = _chain_deltas_batched(
            f, x[None, :], background, perms[None, :, :], max_eval_rows,
            model=model,
        )[0]
    else:
        raise ValueError(f"unknown shapley backend {backend!r}")
    phi = _reduce_chains(perms, deltas)
    return _residual_correct(phi, f, x, background)


def shapley_values_batch(
    f: Callable[[np.ndarray], np.ndarray],
    X: np.ndarray,
    background: np.ndarray,
    n_permutations: int = 32,
    rng: Optional[np.random.Generator] = None,
    backend: str = "batched",
    perms: Optional[np.ndarray] = None,
    max_eval_rows: int = _MAX_EVAL_ROWS,
    model=None,
) -> np.ndarray:
    """Explain many configs in one masked-evaluation pass. Returns (n, d).

    Permutation matrices are drawn per config *sequentially* from ``rng``
    (config i's draws happen after config i-1's), replaying the draw order
    of one :func:`shapley_values` call per row — so the batch is
    bit-identical to the sequential per-config loop with a shared rng, on
    either backend. ``model`` (the forest behind ``f``) opts the batched
    backend into the bitvector chain kernel.
    """
    X = np.atleast_2d(np.asarray(X, dtype=float))
    background = np.atleast_2d(np.asarray(background, dtype=float))
    n, d = X.shape
    if n == 0:
        return np.zeros((0, d))
    if perms is None:
        rng = rng or np.random.default_rng(0)
        perms = np.stack([draw_permutations(d, n_permutations, rng) for _ in range(n)])
    else:
        perms = np.asarray(perms)
        if perms.ndim == 2:  # one shared matrix for every config
            perms = np.broadcast_to(perms[None, :, :], (n, *perms.shape))
    if backend == "loop":
        deltas = np.stack(
            [_chain_deltas_loop(f, X[i], background, perms[i]) for i in range(n)]
        )
    elif backend == "batched":
        deltas = _chain_deltas_batched(
            f, X, background, perms, max_eval_rows, model=model
        )
    else:
        raise ValueError(f"unknown shapley backend {backend!r}")
    # residual anchors: f(x_i) is evaluated per config in single-row calls —
    # numpy picks a different (pairwise vs sequential) tree-mean reduction
    # for 1-row vs n-row batches, so one f(X) call would drift 1 ULP from
    # the sequential per-config protocol the docstring promises
    fxs = np.array([float(f(X[i : i + 1])[0]) for i in range(n)])
    f0 = float(np.asarray(f(background)).mean())
    out = np.empty((n, d), dtype=float)
    for i in range(n):
        phi = _reduce_chains(perms[i], deltas[i])
        out[i] = _residual_correct(phi, f, X[i], background, fx=float(fxs[i]), f0=f0)
    return out


def shapley_values_exact(
    f: Callable[[np.ndarray], np.ndarray],
    x: np.ndarray,
    background: np.ndarray,
) -> np.ndarray:
    """Exact enumeration (d <= 8 or so) — used to validate the sampler."""
    x = np.asarray(x, dtype=float)
    background = np.atleast_2d(np.asarray(background, dtype=float))
    d = len(x)
    # value function over all 2^d subsets
    n_sub = 1 << d
    masks = np.zeros((n_sub, d), dtype=bool)
    for s in range(n_sub):
        for j in range(d):
            masks[s, j] = bool(s >> j & 1)
    vals = _eval_masked(f, x, background, masks)
    phi = np.zeros(d)
    count = 0
    for p in permutations(range(d)):
        s = 0
        prev = vals[0]
        for j in p:
            s |= 1 << j
            cur = vals[s]
            phi[j] += cur - prev
            prev = cur
        count += 1
    return phi / count
