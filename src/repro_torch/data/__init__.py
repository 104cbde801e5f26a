"""The port's input pipeline (counterpart of ``repro.data``)."""
from .pipeline import StreamingPipeline, SyntheticLM, make_batch_stream

__all__ = ["StreamingPipeline", "SyntheticLM", "make_batch_stream"]
