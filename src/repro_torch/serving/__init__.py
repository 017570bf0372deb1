from .engine import Request, ServingEngine, prefill_with_cache

__all__ = ["Request", "ServingEngine", "prefill_with_cache"]
