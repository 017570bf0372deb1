from .pipeline import SyntheticTokenPipeline

__all__ = ["SyntheticTokenPipeline"]
