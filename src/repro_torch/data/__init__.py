from .pipeline import DataConfig, SyntheticEncDec, SyntheticLM, SyntheticVLM, make_pipeline

__all__ = ["DataConfig", "SyntheticLM", "SyntheticEncDec", "SyntheticVLM", "make_pipeline"]
