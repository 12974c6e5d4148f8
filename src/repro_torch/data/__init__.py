"""The training data pipeline (counterpart of `repro.data`)."""
from .pipeline import (DataConfig, PackedFileDataset, SyntheticLM,
                       make_pipeline, write_token_file)

__all__ = ["DataConfig", "PackedFileDataset", "SyntheticLM",
           "make_pipeline", "write_token_file"]
