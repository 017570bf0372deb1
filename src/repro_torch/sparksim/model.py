"""Analytic Spark SQL cost model.

Latency of a query = scan + compute + shuffle + scheduling terms, with
memory-pressure (spill), GC, and OOM-failure mechanics, under a hardware
scenario (nodes x cores x RAM, Table 2 of the paper). The model is built
so the paper's *phenomena* hold structurally:

- heterogeneous per-query sensitivities (scan- vs shuffle- vs compute- vs
  memory-bound) => representative query subsets exist (SQL Selection works);
- profiles drift along the query index => prefix subsets are biased
  (Early Stop decorrelates);
- bottlenecks bind only at scale (spill/OOM/network saturation vanish on
  small data; small data underutilizes the cluster) => reducing data volume
  reshuffles config rankings (Data Volume decorrelates, Fig. 1b);
- the resource-sizing optimum moves with hardware and scale, but smoothly
  => historical tasks transfer (Figs. 3-4);
- oversized executor heaps pay superlinear GC; undersized ones spill then
  OOM => the spark.executor.memory discussion in §1.

All stochasticity is multiplicative lognormal noise seeded per
(task, config, query): repeated evaluation of a config is deterministic.
The lognormal draw is derived from a blake2b hash of the cell identity via
Box-Muller (no per-cell ``np.random.Generator`` construction), so the same
formula evaluates one cell or a whole (configs x queries) grid.

Two evaluation paths share the model:

- ``evaluate``        — the reference scalar path: queries walked in order,
  one ``query_latency`` call per query.
- ``evaluate_batch``  — the vectorized engine: per-query profile arrays are
  precomputed at construction, per-config scalars are extracted once per
  config, and the full (configs x queries) latency grid is produced with
  NumPy broadcasting. Early-stop / OOM masking is applied per config after
  the grid, reproducing ``evaluate``'s sequential semantics (latencies,
  costs, failure flags and early-stop charging) bit-for-bit.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["HardwareScenario", "QueryProfile", "SparkCostModel", "SCENARIOS"]

Config = Dict[str, Any]


@dataclass(frozen=True)
class HardwareScenario:
    name: str
    nodes: int
    cores: int   # per node
    ram_gb: int  # per node


# Table 2 of the paper
SCENARIOS: Dict[str, HardwareScenario] = {
    "A": HardwareScenario("A", 3, 64, 256),
    "B": HardwareScenario("B", 3, 32, 128),
    "C": HardwareScenario("C", 3, 32, 256),
    "D": HardwareScenario("D", 3, 64, 128),
    "E": HardwareScenario("E", 2, 64, 256),
    "F": HardwareScenario("F", 2, 32, 128),
    "G": HardwareScenario("G", 2, 32, 256),
    "H": HardwareScenario("H", 2, 64, 128),
}


@dataclass
class QueryProfile:
    name: str
    scan_frac: float          # fraction of the dataset this query scans
    shuffle_frac: float       # shuffle bytes as a fraction of scanned bytes
    cpu_per_gb: float         # CPU-seconds per scanned GB (per slot)
    mem_per_gb: float         # working-set GB per shuffled GB per task unit
    skew: float               # >= 1; max-partition inflation
    small_table_mb: float     # size of broadcastable dim table (0 = none)
    broadcast_benefit: float  # shuffle reduction when broadcast fires (0..0.9)
    parallelism_ceiling: int  # max useful concurrent tasks
    oom_resilience: float     # spill ratio beyond which the query OOMs
    gc_sensitivity: float     # how much long-heap GC hurts this query


def _stable_u32(*parts: str) -> int:
    h = hashlib.blake2b("|".join(parts).encode(), digest_size=4)
    return int.from_bytes(h.digest(), "little")


def make_query_profiles(benchmark: str, n_queries: int, seed: int = 1234) -> List[QueryProfile]:
    """Benchmark-level profiles: identical across tasks of the benchmark."""
    rng = np.random.default_rng(_stable_u32(benchmark, str(seed)))
    profiles = []
    for i in range(n_queries):
        t = i / max(n_queries - 1, 1)  # index drift: later queries more shuffle/memory bound
        # each query touches a slice of the dataset; the whole workload scans
        # ~6x the dataset regardless of how many queries it is split into
        scan_frac = float(np.clip(rng.lognormal(np.log(6.0 / n_queries), 0.7), 0.01, 1.0))
        shuffle_frac = float(np.clip(rng.beta(1.6, 4.0) * (0.5 + 1.1 * t) * 1.6, 0.01, 1.8))
        cpu_per_gb = float(np.clip(rng.lognormal(np.log(2.2), 0.5) * (1.3 - 0.5 * t), 0.3, 10.0))
        mem_per_gb = float(np.clip(rng.lognormal(np.log(1.0), 0.45) * (0.6 + 0.9 * t), 0.15, 4.0))
        skew = float(1.0 + rng.beta(1.2, 4.0) * 5.0 * (0.4 + 0.6 * t))
        has_bjoin = rng.random() < 0.55
        small_table_mb = float(rng.uniform(4, 320)) if has_bjoin else 0.0
        broadcast_benefit = float(rng.uniform(0.25, 0.75)) if has_bjoin else 0.0
        parallelism_ceiling = int(rng.integers(48, 384))
        oom_resilience = float(rng.uniform(2.0, 5.0))
        gc_sensitivity = float(rng.uniform(0.3, 1.6))
        profiles.append(
            QueryProfile(
                name=f"q{i + 1}",
                scan_frac=scan_frac,
                shuffle_frac=shuffle_frac,
                cpu_per_gb=cpu_per_gb,
                mem_per_gb=mem_per_gb,
                skew=skew,
                small_table_mb=small_table_mb,
                broadcast_benefit=broadcast_benefit,
                parallelism_ceiling=parallelism_ceiling,
                oom_resilience=oom_resilience,
                gc_sensitivity=gc_sensitivity,
            )
        )
    return profiles


# machine constants (per-slot / per-node bandwidths, seconds). Calibrated so
# that a tuned TPC-H/600GB run takes ~1.5h and a poor one tens of hours —
# matching the paper's ~29 full evaluations per 48h budget (§1, Fig. 1a).
IO_BW_PER_SLOT = 0.045       # GB/s effective scan bandwidth per task slot
NET_BW_PER_NODE = 0.30       # GB/s shuffle network bandwidth per node
PROC_BW_PER_SLOT = 0.10      # GB/s shuffle processing bandwidth per slot
TASK_OVERHEAD = 0.04         # s scheduling overhead per task
TIMEOUT_FACTOR = 4.0         # failed queries charge 4x their nominal latency

CODEC = {  # (compression ratio, cpu overhead factor)
    "lz4": (0.55, 1.00),
    "snappy": (0.60, 0.97),
    "zstd": (0.38, 1.12),
}


class SparkCostModel:
    def __init__(
        self,
        benchmark: str,
        data_gb: float,
        hardware: HardwareScenario,
        seed: int = 1234,
        noise: float = 0.03,
    ):
        self.benchmark = benchmark
        self.data_gb = float(data_gb)
        self.hw = hardware
        self.seed = seed
        self.noise = noise
        n_queries = {"tpch": 22, "tpcds": 99}[benchmark]
        self.profiles = make_query_profiles(benchmark, n_queries, seed=seed)
        # per-query profile arrays, precomputed once for the batched engine
        self._q = {
            name: np.array([getattr(p, name) for p in self.profiles])
            for name in (
                "scan_frac", "shuffle_frac", "cpu_per_gb", "mem_per_gb", "skew",
                "small_table_mb", "broadcast_benefit", "oom_resilience",
                "gc_sensitivity",
            )
        }
        self._q["parallelism_ceiling"] = np.array(
            [p.parallelism_ceiling for p in self.profiles], dtype=np.int64
        )

    # ------------------------------------------------------------ resources
    def _executors(self, cfg: Config) -> Tuple[int, int, float]:
        """Return (executors, slots, task_mem_gb). Spark sizing semantics:
        the cluster caps how many executors actually launch."""
        hw = self.hw
        cores = int(cfg["spark.executor.cores"])
        mem = float(cfg["spark.executor.memory"])
        overhead_gb = float(cfg["spark.executor.memoryOverhead"]) / 1024.0
        per_node_by_cores = hw.cores // max(cores, 1)
        per_node_by_mem = int((hw.ram_gb * 0.92) // max(mem + overhead_gb, 0.5))
        launched = min(
            int(cfg["spark.executor.instances"]),
            max(per_node_by_cores, 0) * hw.nodes,
            max(per_node_by_mem, 0) * hw.nodes,
        )
        launched = max(launched, 1)
        slots = launched * cores
        # unified memory: (heap - 300MB) * fraction, split across concurrent tasks
        frac = float(cfg["spark.memory.fraction"])
        storage = float(cfg["spark.memory.storageFraction"])
        usable = max(mem - 0.3, 0.2) * frac * (1.0 - 0.5 * storage)
        offheap_gb = (
            float(cfg["spark.memory.offHeap.size"]) / 1024.0
            if cfg.get("spark.memory.offHeap.enabled")
            else 0.0
        )
        task_mem = (usable + 0.7 * offheap_gb) / max(cores, 1)
        return launched, slots, task_mem

    # ---------------------------------------------------------- query model
    def query_latency(
        self, cfg: Config, q: QueryProfile, data_fraction: float = 1.0
    ) -> Tuple[float, bool, Dict[str, float]]:
        """Return (latency_s, failed, latency breakdown)."""
        hw = self.hw
        E, slots, task_mem = self._executors(cfg)
        data_gb = self.data_gb * float(np.clip(data_fraction, 1e-3, 1.0))
        scan_gb = q.scan_frac * data_gb

        eff_slots = max(min(slots, q.parallelism_ceiling * hw.nodes), 1)

        # ---- scan: wave quantization from maxPartitionBytes
        mpb_gb = float(cfg["spark.sql.files.maxPartitionBytes"]) / 1024.0
        map_tasks = max(int(np.ceil(scan_gb / max(mpb_gb, 1e-3))), 1)
        waves = np.ceil(map_tasks / eff_slots)
        util = map_tasks / (waves * eff_slots)  # <=1; poor when few big tasks
        codec_ratio, codec_cpu = CODEC[cfg["spark.io.compression.codec"]]
        scan_time = (
            scan_gb / (IO_BW_PER_SLOT * eff_slots * max(util, 1e-3)) * codec_cpu
            + map_tasks * TASK_OVERHEAD / max(slots, 1)
        )

        # ---- compute
        ser_factor = 0.86 if cfg["spark.serializer"] == "kryo" else 1.0
        if cfg["spark.serializer"] == "kryo" and float(cfg["spark.kryoserializer.buffer.max"]) < 16:
            ser_factor *= 1.06  # undersized kryo buffer causes re-serialization
        codegen = 0.93 if cfg.get("spark.sql.codegen.wholeStage", True) else 1.0
        gc_factor = 1.0 + 0.05 * q.gc_sensitivity * (float(cfg["spark.executor.memory"]) / 12.0) ** 1.4
        compute_time = q.cpu_per_gb * scan_gb / eff_slots * ser_factor * codegen * gc_factor

        # ---- shuffle
        shuffle_gb = q.shuffle_frac * scan_gb
        bcast_thresh = float(cfg["spark.sql.autoBroadcastJoinThreshold"])
        if q.small_table_mb > 0 and bcast_thresh >= q.small_table_mb:
            shuffle_gb *= 1.0 - q.broadcast_benefit
        p = float(cfg["spark.sql.shuffle.partitions"])
        aqe = bool(cfg["spark.sql.adaptive.enabled"])
        if aqe and cfg["spark.sql.adaptive.coalescePartitions.enabled"]:
            # AQE coalesce pulls the effective partition count toward a
            # data-derived target (128MB per partition)
            p_target = max(shuffle_gb / 0.125, eff_slots)
            p = np.clip(p, p_target * 0.75, None) if p > p_target else 0.5 * (p + p_target)
        skew = q.skew
        if aqe and cfg["spark.sql.adaptive.skewJoin.enabled"]:
            skew = 1.0 + (skew - 1.0) * 0.35
        comp_on = bool(cfg["spark.shuffle.compress"])
        wire_gb = shuffle_gb * (codec_ratio if comp_on else 1.0)
        comp_cpu = codec_cpu if comp_on else 1.0
        net_time = 2.0 * wire_gb / (NET_BW_PER_NODE * hw.nodes)
        per_part_gb = shuffle_gb * skew / max(p, 1.0)
        reduce_waves = np.ceil(p / eff_slots)
        fetch_eff = 1.0 + 0.04 * np.log2(48.0 / np.clip(float(cfg["spark.reducer.maxSizeInFlight"]), 8, 256))
        buf_eff = 1.0 + 0.03 * np.log2(64.0 / np.clip(float(cfg["spark.shuffle.file.buffer"]), 16, 1024))
        proc_time = (
            reduce_waves * per_part_gb / PROC_BW_PER_SLOT * comp_cpu * max(fetch_eff, 0.9) * max(buf_eff, 0.9)
        )
        sched_time = p * TASK_OVERHEAD / max(slots, 1)

        # ---- memory pressure: spill & OOM
        working_gb = per_part_gb * q.mem_per_gb
        spill_ratio = working_gb / max(task_mem, 1e-3)
        failed = bool(spill_ratio > q.oom_resilience)
        spill_mult = 1.0
        if spill_ratio > 1.0:
            spill_comp = 0.85 if cfg.get("spark.shuffle.spill.compress", True) else 1.0
            spill_mult = 1.0 + 0.9 * spill_comp * (spill_ratio - 1.0)
        shuffle_time = (net_time + proc_time) * spill_mult + sched_time

        # ---- straggler/scheduling extras
        tail = 1.0 + 0.06 * (skew - 1.0)
        if cfg["spark.speculation"]:
            tail = 1.0 + (tail - 1.0) * 0.55  # speculation clips the tail
        loc_wait = float(cfg["spark.locality.wait"])
        tail += 0.004 * loc_wait * (waves + reduce_waves)

        latency = (scan_time + compute_time + shuffle_time) * tail

        # ---- long-tail knobs: tiny deterministic per-(knob,value) wiggle
        latency *= self._minor_knob_factor(cfg)

        breakdown = {
            "scan": float(scan_time),
            "compute": float(compute_time),
            "shuffle": float(shuffle_time),
            "spill_ratio": float(spill_ratio),
            "slots": float(slots),
            "executors": float(E),
        }
        if failed:
            return TIMEOUT_FACTOR * latency, True, breakdown
        return float(latency), False, breakdown

    def _minor_knob_factor(self, cfg: Config) -> float:
        """Sub-percent deterministic effects for the long-tail knobs."""
        f = 1.0
        for name in (
            "spark.rpc.askTimeout",
            "spark.network.timeout",
            "spark.storage.memoryMapThreshold",
            "spark.task.maxFailures",
            "spark.cleaner.periodicGC.interval",
            "spark.sql.codegen.maxFields",
            "spark.sql.statistics.histogram.numBins",
        ):
            u = _stable_u32(name, repr(cfg.get(name))) / 2**32
            f *= 1.0 + (u - 0.5) * 0.004
        return f

    # ------------------------------------------------------------- noise
    def _cell_seeds(self, cfg_key: str, query_indices: Sequence[int]) -> np.ndarray:
        """64-bit hash per (config, query) cell, one prefix hash per config."""
        prefix = hashlib.blake2b(digest_size=8)
        prefix.update(
            "|".join([self.benchmark, str(self.data_gb), self.hw.name, cfg_key, ""]).encode()
        )
        seeds = np.empty(len(query_indices), dtype=np.uint64)
        for i, qi in enumerate(query_indices):
            h = prefix.copy()
            h.update(str(qi).encode())
            seeds[i] = int.from_bytes(h.digest(), "little")
        return seeds

    def _lognormal_from_seeds(self, seeds: np.ndarray) -> np.ndarray:
        """Multiplicative lognormal noise from 64-bit seeds via Box-Muller."""
        hi = (seeds >> np.uint64(32)).astype(np.float64)
        lo = (seeds & np.uint64(0xFFFFFFFF)).astype(np.float64)
        u1 = (hi + 0.5) / 2**32
        u2 = (lo + 0.5) / 2**32
        z = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)
        return np.exp(self.noise * z)

    def _noise(self, cfg_key: str, qi: int) -> float:
        return float(self._lognormal_from_seeds(self._cell_seeds(cfg_key, [qi]))[0])

    def evaluate(
        self,
        cfg: Config,
        query_indices: Optional[List[int]] = None,
        data_fraction: float = 1.0,
        cost_cap: Optional[float] = None,
    ) -> Tuple[List[float], List[float], bool, str]:
        """Run queries in order. Returns (latencies, costs, failed, reason)."""
        idx = list(query_indices) if query_indices is not None else list(range(len(self.profiles)))
        cfg_key = self._cfg_key(cfg)
        lats: List[float] = []
        costs: List[float] = []
        total = 0.0
        for qi in idx:
            lat, failed, _ = self.query_latency(cfg, self.profiles[qi], data_fraction)
            lat *= self._noise(cfg_key, qi)
            if cost_cap is not None and total + lat > cost_cap:
                # §6.3 median early stop: abort, charge only up to the cap
                costs.append(max(cost_cap - total, 0.0))
                lats.append(lat)
                return lats, costs, True, "early_stop"
            lats.append(lat)
            costs.append(lat)
            total += lat
            if failed:
                return lats, costs, True, "oom"
        return lats, costs, False, ""

    @staticmethod
    def _cfg_key(cfg: Config) -> str:
        return repr(sorted((k, repr(v)) for k, v in cfg.items()))

    # ----------------------------------------------------- batched evaluation
    def _config_scalars(self, cfg: Config) -> Dict[str, float]:
        """Per-config constants of the latency model (everything that does
        not depend on the query), with the same expressions as
        ``query_latency`` so the batched grid matches it bit-for-bit."""
        E, slots, task_mem = self._executors(cfg)
        codec_ratio, codec_cpu = CODEC[cfg["spark.io.compression.codec"]]
        ser_factor = 0.86 if cfg["spark.serializer"] == "kryo" else 1.0
        if cfg["spark.serializer"] == "kryo" and float(cfg["spark.kryoserializer.buffer.max"]) < 16:
            ser_factor *= 1.06
        codegen = 0.93 if cfg.get("spark.sql.codegen.wholeStage", True) else 1.0
        aqe = bool(cfg["spark.sql.adaptive.enabled"])
        comp_on = bool(cfg["spark.shuffle.compress"])
        fetch_eff = 1.0 + 0.04 * np.log2(48.0 / np.clip(float(cfg["spark.reducer.maxSizeInFlight"]), 8, 256))
        buf_eff = 1.0 + 0.03 * np.log2(64.0 / np.clip(float(cfg["spark.shuffle.file.buffer"]), 16, 1024))
        return {
            "slots_i": slots,
            "task_mem_floor": max(task_mem, 1e-3),
            "mpb_gb_floor": max(float(cfg["spark.sql.files.maxPartitionBytes"]) / 1024.0, 1e-3),
            "codec_cpu": codec_cpu,
            "ser_factor": ser_factor,
            "codegen": codegen,
            "gc_pow": (float(cfg["spark.executor.memory"]) / 12.0) ** 1.4,
            "bcast_thresh": float(cfg["spark.sql.autoBroadcastJoinThreshold"]),
            "p0": float(cfg["spark.sql.shuffle.partitions"]),
            "aqe_coalesce": float(aqe and cfg["spark.sql.adaptive.coalescePartitions.enabled"]),
            "aqe_skew": float(aqe and cfg["spark.sql.adaptive.skewJoin.enabled"]),
            "wire_factor": codec_ratio if comp_on else 1.0,
            "comp_cpu": codec_cpu if comp_on else 1.0,
            "fetch_eff": max(fetch_eff, 0.9),
            "buf_eff": max(buf_eff, 0.9),
            "spill_gain": 0.9 * (0.85 if cfg.get("spark.shuffle.spill.compress", True) else 1.0),
            "speculation": float(bool(cfg["spark.speculation"])),
            "loc_wait": float(cfg["spark.locality.wait"]),
            "minor": self._minor_knob_factor(cfg),
        }

    def _latency_grid(
        self, cfgs: Sequence[Config], idx: List[int], data_fraction: float
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Noisy latency grid for (configs x queries).

        Returns ``(lat, failed)`` of shape (C, Q): ``lat`` already includes
        the OOM timeout factor and the deterministic per-cell noise, exactly
        as the scalar ``evaluate`` path computes per cell.
        """
        hw = self.hw
        C, Q = len(cfgs), len(idx)
        sc = {k: np.empty(C) for k in (
            "task_mem_floor", "mpb_gb_floor", "codec_cpu", "ser_factor",
            "codegen", "gc_pow", "bcast_thresh", "p0", "aqe_coalesce", "aqe_skew",
            "wire_factor", "comp_cpu", "fetch_eff", "buf_eff", "spill_gain",
            "speculation", "loc_wait", "minor",
        )}
        slots_i = np.empty(C, dtype=np.int64)
        seeds = np.empty((C, Q), dtype=np.uint64)
        for ci, cfg in enumerate(cfgs):
            s = self._config_scalars(cfg)
            for k in sc:
                sc[k][ci] = s[k]
            slots_i[ci] = s["slots_i"]
            seeds[ci] = self._cell_seeds(self._cfg_key(cfg), idx)

        def col(name):  # (C, 1) view of a per-config scalar
            return sc[name][:, None]

        q = {k: v[idx] for k, v in self._q.items()}
        data_gb = self.data_gb * float(np.clip(data_fraction, 1e-3, 1.0))
        scan_gb = q["scan_frac"] * data_gb                               # (Q,)
        slots = slots_i[:, None]                                         # (C, 1)
        eff_slots = np.maximum(
            np.minimum(slots, q["parallelism_ceiling"][None, :] * hw.nodes), 1
        )                                                                # (C, Q)

        # ---- scan (operation order mirrors query_latency exactly)
        map_tasks = np.maximum(np.ceil(scan_gb[None, :] / col("mpb_gb_floor")), 1.0)
        waves = np.ceil(map_tasks / eff_slots)
        util = map_tasks / (waves * eff_slots)
        scan_time = (
            scan_gb[None, :] / (IO_BW_PER_SLOT * eff_slots * np.maximum(util, 1e-3)) * col("codec_cpu")
            + map_tasks * TASK_OVERHEAD / np.maximum(slots, 1)
        )

        # ---- compute
        gc_factor = 1.0 + (0.05 * q["gc_sensitivity"])[None, :] * col("gc_pow")
        compute_time = (
            (q["cpu_per_gb"] * scan_gb)[None, :] / eff_slots
            * col("ser_factor") * col("codegen") * gc_factor
        )

        # ---- shuffle
        shuffle_gb = np.broadcast_to((q["shuffle_frac"] * scan_gb)[None, :], (C, Q))
        bcast = (q["small_table_mb"][None, :] > 0) & (col("bcast_thresh") >= q["small_table_mb"][None, :])
        shuffle_gb = np.where(bcast, shuffle_gb * (1.0 - q["broadcast_benefit"])[None, :], shuffle_gb)
        p = np.broadcast_to(col("p0"), (C, Q))
        p_target = np.maximum(shuffle_gb / 0.125, eff_slots)
        p_coalesced = np.where(p > p_target, p, 0.5 * (p + p_target))
        p = np.where(col("aqe_coalesce") > 0, p_coalesced, p)
        skew = np.broadcast_to(q["skew"][None, :], (C, Q))
        skew = np.where(col("aqe_skew") > 0, 1.0 + (skew - 1.0) * 0.35, skew)
        wire_gb = shuffle_gb * col("wire_factor")
        net_time = 2.0 * wire_gb / (NET_BW_PER_NODE * hw.nodes)
        per_part_gb = shuffle_gb * skew / np.maximum(p, 1.0)
        reduce_waves = np.ceil(p / eff_slots)
        proc_time = (
            reduce_waves * per_part_gb / PROC_BW_PER_SLOT * col("comp_cpu")
            * col("fetch_eff") * col("buf_eff")
        )
        sched_time = p * TASK_OVERHEAD / np.maximum(slots, 1)

        # ---- memory pressure: spill & OOM
        working_gb = per_part_gb * q["mem_per_gb"][None, :]
        spill_ratio = working_gb / col("task_mem_floor")
        failed = spill_ratio > q["oom_resilience"][None, :]
        spill_mult = np.where(
            spill_ratio > 1.0, 1.0 + col("spill_gain") * (spill_ratio - 1.0), 1.0
        )
        shuffle_time = (net_time + proc_time) * spill_mult + sched_time

        # ---- straggler/scheduling extras
        tail = 1.0 + 0.06 * (skew - 1.0)
        tail = np.where(col("speculation") > 0, 1.0 + (tail - 1.0) * 0.55, tail)
        tail = tail + 0.004 * col("loc_wait") * (waves + reduce_waves)

        latency = (scan_time + compute_time + shuffle_time) * tail
        latency = latency * col("minor")
        latency = np.where(failed, TIMEOUT_FACTOR * latency, latency)
        latency = latency * self._lognormal_from_seeds(seeds)
        return latency, failed

    def evaluate_batch(
        self,
        cfgs: Sequence[Config],
        query_indices: Optional[List[int]] = None,
        data_fraction: float = 1.0,
        cost_cap: Union[None, float, Sequence[Optional[float]]] = None,
    ) -> List[Tuple[List[float], List[float], bool, str]]:
        """Vectorized ``evaluate`` over many configs at once.

        Computes the full (configs x queries) latency grid with one
        broadcasted NumPy pass, then applies per-config sequential masking
        (cost-cap early stop, OOM abort) so each returned tuple matches
        ``evaluate(cfg, ...)`` bit-for-bit. ``cost_cap`` may be a scalar
        (same cap for every config) or a per-config sequence.
        """
        idx = list(query_indices) if query_indices is not None else list(range(len(self.profiles)))
        caps: List[Optional[float]]
        if cost_cap is None or np.isscalar(cost_cap):
            caps = [cost_cap] * len(cfgs)  # type: ignore[list-item]
        else:
            caps = list(cost_cap)
            if len(caps) != len(cfgs):
                raise ValueError(f"{len(caps)} cost caps for {len(cfgs)} configs")
        lat, failed = self._latency_grid(cfgs, idx, data_fraction)
        out: List[Tuple[List[float], List[float], bool, str]] = []
        n = len(idx)
        for ci in range(len(cfgs)):
            row = lat[ci]
            # cumulative cost *before* each query, via the same sequential
            # additions the scalar loop performs (np.cumsum accumulates
            # left-to-right, so the partial sums are bitwise identical)
            before = np.concatenate(([0.0], np.cumsum(row)[:-1]))
            cap = caps[ci]
            j_es = n
            if cap is not None:
                hits = np.nonzero(before + row > cap)[0]
                if hits.size:
                    j_es = int(hits[0])
            ooms = np.nonzero(failed[ci])[0]
            j_oom = int(ooms[0]) if ooms.size else n
            if j_es <= j_oom and j_es < n:
                lats = [float(x) for x in row[: j_es + 1]]
                costs = [float(x) for x in row[:j_es]] + [max(float(cap) - float(before[j_es]), 0.0)]
                out.append((lats, costs, True, "early_stop"))
            elif j_oom < n:
                lats = [float(x) for x in row[: j_oom + 1]]
                out.append((lats, list(lats), True, "oom"))
            else:
                lats = [float(x) for x in row]
                out.append((lats, list(lats), False, ""))
        return out
