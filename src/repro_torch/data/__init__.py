from .pipeline import SyntheticCorpus, LengthBucketer

__all__ = ["SyntheticCorpus", "LengthBucketer"]
