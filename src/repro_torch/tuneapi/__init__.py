from .workload import EvalResult, Workload, Budget

__all__ = ["EvalResult", "Workload", "Budget"]
