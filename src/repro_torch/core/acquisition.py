"""Acquisition functions and rank aggregation (paper §3.3, §6.2), in torch.

The acquisition path is a batched tensor program on the surrogates'
device: ``score_sources`` computes the EI matrix for *all* surrogate
sources in one pass (PRF sources share a single packed-forest descent via
``ForestPlane``, kernel K1), and ``aggregate_ranks`` turns the (S, N) score
matrix into weighted aggregate ranks through the radix rank (kernel K2).

Bit-equivalence contract: EI here instantiates the reference's portable
Cephes-style ``exp``/``ndtr`` expression tree (``make_portable_kernels``
of ``repro.core.acquisition``) with torch float64 ops. Eager torch runs
every op as its own kernel, so no multiply contracts into an add, and
every division goes through a tensor divisor and the square root through
an IEEE ``sqrt`` (``repro_torch.numerics``), so EI is bit-identical to the reference's ``expected_improvement``.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..kernels.forest_eval.rank import rank_rows
from ..numerics import div_scalar, reduce_sum, sqrt
from .surrogate import ForestPlane, ProbabilisticRandomForest

__all__ = [
    "EI_VAR_FLOOR",
    "normal_cdf",
    "expected_improvement",
    "ei_matrix",
    "ei_scores",
    "predict_sources",
    "score_sources",
    "aggregate_ranks",
    "make_portable_kernels",
    "set_plane_cache_size",
    "plane_cache_stats",
    "acquisition_backend",
    "acquisition_pool",
    "get_acquisition_backend",
    "get_acquisition_pool",
    "set_acquisition_backend",
    "set_acquisition_pool",
]

# The variance floor the reference's numpy and jax paths share.
EI_VAR_FLOOR = 1e-12

# ---------------------------------------------------------------------------
# Portable Cephes double-precision exp / ndtr (netlib cephes, exp.c + ndtr.c
# coefficient tables), the reference's tables and op sequence.
# ---------------------------------------------------------------------------

_SQRT2 = math.sqrt(2.0)
_SQRT2PI = float(np.sqrt(2 * np.pi))

# ---------------------------------------------------------------------------
# Portable Cephes double-precision exp / ndtr (netlib cephes, exp.c + ndtr.c
# coefficient tables). Polynomial ratios + exact power-of-two scaling via
# exponent-field bitcasts: every step is IEEE mul/add/div/sqrt/compare, so
# instantiating the same expression tree under numpy and jax yields
# bit-identical outputs — provided products feeding adds are protected from
# FMA contraction (the ``mul`` hook).
# ---------------------------------------------------------------------------

_MAXLOG = 709.782712893383996843
_MINLOG = -708.396418532264106224
_LOG2E = 1.4426950408889634073599
_EXP_C1 = 6.93145751953125e-1
_EXP_C2 = 1.42860682030941723212e-6
_SQRT1_2 = 0.70710678118654752440
_MIN_NORMAL = 2.2250738585072014e-308  # smallest normal float64 (FTZ cutoff)

_EXP_P = (1.26177193074810590878e-4, 3.02994407707441961300e-2,
          9.99999999999999999910e-1)
_EXP_Q = (3.00198505138664455042e-6, 2.52448340349684104192e-3,
          2.27265548208155028766e-1, 2.00000000000000000005e0)

_ERF_T = (9.60497373987051638749e0, 9.00260197203842689217e1,
          2.23200534594684319226e3, 7.00332514112805075473e3,
          5.55923013010394962768e4)
_ERF_U = (3.35617141647503099647e1, 5.21357949780152679795e2,
          4.59432382970980127987e3, 2.26290000613890934246e4,
          4.92673942608635921086e4)
_ERFC_P = (2.46196981473530512524e-10, 5.64189564831068821977e-1,
           7.46321056442269912687e0, 4.86371970985681366614e1,
           1.96520832956077098242e2, 5.26445194995477358631e2,
           9.34528527171957607540e2, 1.02755188689515710272e3,
           5.57535335369399327526e2)
_ERFC_Q = (1.32281951154744992508e1, 8.67072140885989742329e1,
           3.54937778887819891062e2, 9.75708501743205489753e2,
           1.82390916687909736289e3, 2.24633760818710981792e3,
           1.65666309194161350182e3, 5.57535340817727675546e2)
_ERFC_R = (5.64189583547755073984e-1, 1.27536670759978104416e0,
           5.01905042251180477414e0, 6.16021097993053585195e0,
           7.40974269950448939160e0, 2.97886665372100240670e0)
_ERFC_S = (2.26052863220117276590e0, 9.39603524938001434673e0,
           1.20489539808096656605e1, 3.08326216929483867054e1,
           2.81677489524132947867e1, 7.92101509270425732821e0)



def _pow2(k: torch.Tensor) -> torch.Tensor:
    """Exact 2**k for integral float k in normal range (exponent bitcast)."""
    return ((k.to(torch.int64) + 1023) << 52).view(torch.float64)


def _div(a, b):
    """IEEE division by a tensor or a constant (see ``div_scalar``)."""
    return a / b if isinstance(b, torch.Tensor) else div_scalar(a, b)


def make_portable_kernels() -> Dict[str, callable]:
    """exp64 / ndtr64 / EI: the reference's ``make_portable_kernels``
    expression tree in torch float64 ops, op for op."""

    def ftz(v):
        # the reference flushes the few underflow hazard sites to zero
        return torch.where(torch.abs(v) < _MIN_NORMAL, 0.0 * v, v)

    def polevl(x, cs):
        r = torch.full_like(x, cs[0])
        for c in cs[1:]:
            r = r * x + c
        return r

    def p1evl(x, cs):
        r = x + cs[0]
        for c in cs[1:]:
            r = r * x + c
        return r

    def exp64(x):
        xs = torch.clamp(x, _MINLOG, _MAXLOG)
        k = torch.floor(_LOG2E * xs + 0.5)
        r = xs - k * _EXP_C1
        r = r - k * _EXP_C2
        xx = r * r
        p = r * polevl(xx, _EXP_P)
        w = _div(p, polevl(xx, _EXP_Q) - p)
        w = 1.0 + 2.0 * w
        k1 = torch.floor(k * 0.5)
        k2 = k - k1
        out = (w * _pow2(k1)) * _pow2(k2)
        out = torch.where(x < _MINLOG, 0.0, out)
        return torch.where(x > _MAXLOG, math.inf, out)

    def ndtr64(z):
        x = z * _SQRT1_2
        ax = torch.abs(x)
        xc = torch.clamp(x, -1.0, 1.0)
        zz = xc * xc
        erf_small = _div(xc * polevl(zz, _ERF_T), p1evl(zz, _ERF_U))
        small = 0.5 + 0.5 * erf_small
        a = torch.clamp(ax, 1.0, 100.0)
        ez = exp64((-a) * a)
        p_mid = _div(polevl(a, _ERFC_P), p1evl(a, _ERFC_Q))
        p_big = _div(polevl(a, _ERFC_R), p1evl(a, _ERFC_S))
        ht = ftz(0.5 * (ez * torch.where(a < 8.0, p_mid, p_big)))
        big = torch.where(x > 0, 1.0 - ht, ht)
        return torch.where(ax < 1.0, small, big)

    def ei(mean, var, best):
        std = sqrt(torch.clamp_min(var, EI_VAR_FLOOR))
        diff = best - mean
        z = _div(diff, std)
        phi = ftz(_div(exp64(-0.5 * (z * z)), _SQRT2PI))
        val = ftz(diff * ndtr64(z)) + ftz(std * phi)
        return ftz(torch.clamp_min(val, 0.0))

    return {"exp": exp64, "ndtr": ndtr64, "ei": ei}


_TK = make_portable_kernels()


def _as_f64(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


def normal_cdf(z: torch.Tensor) -> torch.Tensor:
    """Standard-normal CDF Phi(z) (portable Cephes ndtr), float64."""
    return _TK["ndtr"](z.to(torch.float64))


def expected_improvement(mean: torch.Tensor, var, best) -> torch.Tensor:
    """EI for *minimization*: E[max(best - y, 0)], elementwise over the
    broadcast of (mean, var, best) on ``mean``'s device. Variance is
    floored at :data:`EI_VAR_FLOOR`."""
    dev = mean.device
    mean = mean.to(torch.float64)
    return _TK["ei"](mean, _as_f64(var, dev), _as_f64(best, dev))


def ei_matrix(means: torch.Tensor, vars_: torch.Tensor, bests) -> torch.Tensor:
    """Row-wise EI: means/vars_ (S, N), bests (S,) -> EI (S, N)."""
    bests = _as_f64(bests, means.device)
    return expected_improvement(means, vars_, bests[:, None])


def ei_scores(model: ProbabilisticRandomForest, X, best: float) -> np.ndarray:
    """EI of one forest over the points X, as a numpy vector."""
    mean, var = model.predict_tensor(X)
    return expected_improvement(mean, var, best).cpu().numpy()


# ---------------------------------------------------------------------------
# Acquisition backend / pool-mode switches (the reference's
# ``set_acquisition_backend`` / ``set_acquisition_pool``). "staged" keeps the
# staged path (the reference's "numpy"); "fused" routes fusable recommend
# calls through the fused propose step (``core/propose.py``; the
# reference's "jax" and "pallas", which differ only in the descent kernel).
# Pool mode: "device" draws the candidate pool on the device from the
# engine's generator (other draws than the host pool's); "host" uploads the
# generator's numpy pool, so selections are the staged path's bit for bit.
# ---------------------------------------------------------------------------

_ACQ_BACKENDS = ("staged", "fused")
_ACQ_POOLS = ("device", "host")
_ACQ_BACKEND = "staged"
_ACQ_POOL = "device"


def set_acquisition_backend(backend: str) -> str:
    """Set the module-default acquisition backend; returns the previous."""
    global _ACQ_BACKEND
    if backend not in _ACQ_BACKENDS:
        raise ValueError(f"unknown acquisition backend {backend!r}; "
                         f"expected one of {_ACQ_BACKENDS}")
    prev, _ACQ_BACKEND = _ACQ_BACKEND, backend
    return prev


def get_acquisition_backend() -> str:
    return _ACQ_BACKEND


@contextmanager
def acquisition_backend(backend: str):
    prev = set_acquisition_backend(backend)
    try:
        yield
    finally:
        set_acquisition_backend(prev)


def set_acquisition_pool(mode: str) -> str:
    """Set the pool mode of the fused propose step; returns the previous."""
    global _ACQ_POOL
    if mode not in _ACQ_POOLS:
        raise ValueError(f"unknown acquisition pool mode {mode!r}; "
                         f"expected one of {_ACQ_POOLS}")
    prev, _ACQ_POOL = _ACQ_POOL, mode
    return prev


def get_acquisition_pool() -> str:
    return _ACQ_POOL


@contextmanager
def acquisition_pool(mode: str):
    prev = set_acquisition_pool(mode)
    try:
        yield
    finally:
        set_acquisition_pool(prev)


# ---------------------------------------------------------------------------
# Fused planes keyed by the identities of their member arenas. PackedForest
# arenas are immutable and cached per PRF fit, so the same source set maps
# to the same key across recommend calls within a rung; the stored pack list
# guards against id() reuse. LRU with hit/miss/eviction stats (surfaced via
# TuningResult.plane_cache) and a configurable size.
# ---------------------------------------------------------------------------
_PLANE_CACHE: "OrderedDict[tuple, Tuple[list, ForestPlane]]" = OrderedDict()
_PLANE_CACHE_MAX = 8
_PLANE_STATS = {"hits": 0, "misses": 0, "evictions": 0}


def set_plane_cache_size(max_entries: int) -> int:
    """Resize the fused-plane LRU; returns the previous size."""
    global _PLANE_CACHE_MAX
    if max_entries < 1:
        raise ValueError("plane cache needs at least one entry")
    prev, _PLANE_CACHE_MAX = _PLANE_CACHE_MAX, int(max_entries)
    while len(_PLANE_CACHE) > _PLANE_CACHE_MAX:
        _PLANE_CACHE.popitem(last=False)
        _PLANE_STATS["evictions"] += 1
    return prev


def plane_cache_stats() -> Dict[str, int]:
    """Counters in the ``SurrogateStore.cache_stats`` shape."""
    return {**_PLANE_STATS,
            "entries": len(_PLANE_CACHE), "max_entries": _PLANE_CACHE_MAX}


def _plane_for(packs: list) -> ForestPlane:
    key = tuple(id(p) for p in packs)
    entry = _PLANE_CACHE.get(key)
    if entry is not None and all(a is b for a, b in zip(entry[0], packs)):
        _PLANE_CACHE.move_to_end(key)
        _PLANE_STATS["hits"] += 1
        return entry[1]
    _PLANE_STATS["misses"] += 1
    plane = ForestPlane(packs)
    _PLANE_CACHE[key] = (packs, plane)
    while len(_PLANE_CACHE) > _PLANE_CACHE_MAX:
        _PLANE_CACHE.popitem(last=False)
        _PLANE_STATS["evictions"] += 1
    return plane


def predict_sources(
    models: Sequence[ProbabilisticRandomForest], X
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(means, vars), each (S, N) tensors, for all source forests on one
    pool. When several sources are fitted their arenas fuse into one
    :class:`ForestPlane` descent; otherwise each model predicts in turn.
    (The reference's chain-delta ``delta`` argument is not carried: the
    device descent scores every candidate in full.)"""
    fusable = len(models) > 1 and all(m.trees for m in models)
    if fusable:
        return _plane_for([m.pack() for m in models]).predict(X)
    outs = [m.predict_tensor(X) for m in models]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def score_sources(
    models: Sequence[ProbabilisticRandomForest], X, incumbents: Sequence[float],
) -> torch.Tensor:
    """Fused acquisition: EI of every source on every candidate, (S, N)."""
    with obs.span("surrogate_eval", pool=int(X.shape[0]), sources=len(models)):
        means, vars_ = predict_sources(models, X)
        return ei_matrix(means, vars_, np.asarray(incumbents, dtype=float))


def aggregate_ranks(scores: torch.Tensor, weights: Sequence[float]) -> torch.Tensor:
    """Weighted rank aggregation R(x) = sum_i w_i * R_i(x)  (paper §6.2).

    ``scores`` is the (S, N) acquisition matrix; each row is converted to
    ranks where rank 0 = best (highest score), through the radix rank
    (kernel K2). Lower aggregate rank = more promising. Returns the
    aggregate rank per candidate, shape (N,), on the scores' device. The
    weighted sum adds the source rows in numpy's order.
    """
    if not isinstance(scores, torch.Tensor):
        scores = torch.from_numpy(np.atleast_2d(np.asarray(scores, dtype=float)))
    if scores.dim() == 1:
        scores = scores[None, :]
    if scores.numel() == 0:
        raise ValueError("no scores to aggregate")
    ranks = rank_rows(scores.to(torch.float64).contiguous())
    w = torch.as_tensor(np.asarray(weights, dtype=float), device=ranks.device)
    return reduce_sum(w[:, None] * ranks, 0)
