from .workload import CellWorkload, runtime_space

__all__ = ["CellWorkload", "runtime_space"]
