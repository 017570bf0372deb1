"""The 60-knob Spark SQL configuration space (paper §7.1: Tuneful's space
extended to 60 performance-relevant parameters).

Roughly a third of the knobs drive the cost model strongly (the realistic
regime — most Spark knobs barely matter for a given workload, which is
exactly why the paper's knob-selection mechanism exists). The remainder
have small or negligible effects so that compression must *discover*
importance rather than being handed it.
"""

from __future__ import annotations

from ..core.space import BoolKnob, CatKnob, ConfigSpace, FloatKnob, IntKnob

__all__ = ["spark_space", "INFLUENTIAL_KNOBS"]


# knobs the cost model gives first-order effects to
INFLUENTIAL_KNOBS = [
    "spark.executor.instances",
    "spark.executor.cores",
    "spark.executor.memory",
    "spark.executor.memoryOverhead",
    "spark.memory.fraction",
    "spark.memory.storageFraction",
    "spark.sql.shuffle.partitions",
    "spark.sql.files.maxPartitionBytes",
    "spark.sql.autoBroadcastJoinThreshold",
    "spark.io.compression.codec",
    "spark.serializer",
    "spark.shuffle.compress",
    "spark.sql.adaptive.enabled",
    "spark.sql.adaptive.coalescePartitions.enabled",
    "spark.sql.adaptive.skewJoin.enabled",
    "spark.reducer.maxSizeInFlight",
    "spark.shuffle.file.buffer",
    "spark.speculation",
    "spark.locality.wait",
    "spark.default.parallelism",
]


def spark_space() -> ConfigSpace:
    knobs = [
        # ---- resource sizing (first order). Defaults model a plausible
        # ops-team baseline (the paper's "default Spark configuration"),
        # suboptimal by the 2-4x the paper reports, not pathological.
        IntKnob("spark.executor.instances", 2, 48, default=12),
        IntKnob("spark.executor.cores", 1, 16, default=4),
        IntKnob("spark.executor.memory", 2, 64, log=True, default=12),           # GB
        IntKnob("spark.executor.memoryOverhead", 384, 8192, log=True, default=384),  # MB
        FloatKnob("spark.memory.fraction", 0.3, 0.9, default=0.6),
        FloatKnob("spark.memory.storageFraction", 0.1, 0.9, default=0.5),
        # ---- parallelism / partitioning (first order)
        IntKnob("spark.sql.shuffle.partitions", 20, 4000, log=True, default=200),
        IntKnob("spark.default.parallelism", 20, 2000, log=True, default=200),
        IntKnob("spark.sql.files.maxPartitionBytes", 16, 1024, log=True, default=128),  # MB
        IntKnob("spark.sql.autoBroadcastJoinThreshold", 0, 512, default=10),     # MB, 0=off
        # ---- shuffle & IO (first order)
        CatKnob("spark.io.compression.codec", ("lz4", "snappy", "zstd"), default="lz4"),
        CatKnob("spark.serializer", ("java", "kryo"), default="java"),
        BoolKnob("spark.shuffle.compress", default=True),
        IntKnob("spark.reducer.maxSizeInFlight", 8, 256, log=True, default=48),  # MB
        IntKnob("spark.shuffle.file.buffer", 16, 1024, log=True, default=32),    # KB
        # ---- adaptive execution (first order)
        BoolKnob("spark.sql.adaptive.enabled", default=True),
        BoolKnob("spark.sql.adaptive.coalescePartitions.enabled", default=True),
        BoolKnob("spark.sql.adaptive.skewJoin.enabled", default=False),
        # ---- scheduling (moderate)
        BoolKnob("spark.speculation", default=False),
        FloatKnob("spark.locality.wait", 0.0, 10.0, default=3.0),                # s
        # ---- moderate / second order
        BoolKnob("spark.shuffle.spill.compress", default=True),
        IntKnob("spark.kryoserializer.buffer.max", 8, 256, log=True, default=64),  # MB
        IntKnob("spark.sql.inMemoryColumnarStorage.batchSize", 1000, 100000, log=True, default=10000),
        BoolKnob("spark.sql.inMemoryColumnarStorage.compressed", default=True),
        IntKnob("spark.shuffle.io.numConnectionsPerPeer", 1, 8, default=1),
        IntKnob("spark.shuffle.sort.bypassMergeThreshold", 50, 1000, default=200),
        BoolKnob("spark.memory.offHeap.enabled", default=False),
        IntKnob("spark.memory.offHeap.size", 0, 16384, default=0),               # MB
        IntKnob("spark.broadcast.blockSize", 1, 32, default=4),                  # MB
        IntKnob("spark.sql.broadcastTimeout", 120, 1200, default=300),           # s
        FloatKnob("spark.speculation.multiplier", 1.1, 5.0, default=1.5),
        FloatKnob("spark.speculation.quantile", 0.5, 0.95, default=0.75),
        # ---- long tail (negligible effect in the model; must be pruned)
        IntKnob("spark.rpc.askTimeout", 30, 600, default=120),
        IntKnob("spark.network.timeout", 60, 800, default=120),
        IntKnob("spark.storage.memoryMapThreshold", 1, 16, default=2),           # MB
        IntKnob("spark.locality.wait.node", 0, 10, default=3),
        IntKnob("spark.locality.wait.rack", 0, 10, default=3),
        IntKnob("spark.scheduler.revive.interval", 1, 10, default=1),
        IntKnob("spark.task.maxFailures", 1, 8, default=4),
        IntKnob("spark.stage.maxConsecutiveAttempts", 2, 8, default=4),
        BoolKnob("spark.shuffle.service.enabled", default=False),
        IntKnob("spark.shuffle.registration.timeout", 500, 10000, default=5000),
        IntKnob("spark.cleaner.periodicGC.interval", 10, 60, default=30),
        BoolKnob("spark.rdd.compress", default=False),
        IntKnob("spark.io.compression.lz4.blockSize", 8, 128, default=32),       # KB
        IntKnob("spark.io.compression.zstd.level", 1, 9, default=1),
        IntKnob("spark.sql.codegen.maxFields", 50, 500, default=100),
        BoolKnob("spark.sql.codegen.wholeStage", default=True),
        IntKnob("spark.sql.sources.parallelPartitionDiscovery.threshold", 8, 128, default=32),
        IntKnob("spark.sql.statistics.histogram.numBins", 64, 1024, default=254),
        BoolKnob("spark.sql.join.preferSortMergeJoin", default=True),
        IntKnob("spark.sql.limit.scaleUpFactor", 2, 16, default=4),
        IntKnob("spark.sql.shuffle.sortBeforeRepartition", 0, 1, default=1),
        FloatKnob("spark.scheduler.listenerbus.eventqueue.capacity", 1000, 100000, log=True, default=10000),
        IntKnob("spark.broadcast.compress", 0, 1, default=1),
        IntKnob("spark.checkpoint.compress", 0, 1, default=0),
        IntKnob("spark.files.maxPartitionBytes", 16, 512, default=128),
        IntKnob("spark.files.openCostInBytes", 1, 64, default=4),                # MB
        FloatKnob("spark.sql.cbo.joinReorder.card.weight", 0.0, 1.0, default=0.7),
        BoolKnob("spark.sql.cbo.enabled", default=False),
    ]
    assert len(knobs) == 60, f"expected 60 knobs, got {len(knobs)}"
    return ConfigSpace(knobs)
