from .knobs import spark_space, INFLUENTIAL_KNOBS
from .model import HardwareScenario, QueryProfile, SparkCostModel, SCENARIOS
from .workload import SparkWorkload, make_task_id
from .tasks import TaskSpec, all_task_specs, build_knowledge_base, generate_history

__all__ = [
    "spark_space", "INFLUENTIAL_KNOBS",
    "HardwareScenario", "QueryProfile", "SparkCostModel", "SCENARIOS",
    "SparkWorkload", "make_task_id",
    "TaskSpec", "all_task_specs", "build_knowledge_base", "generate_history",
]
