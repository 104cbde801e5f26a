"""The port's parallel layer: ring attention over a group of rank
processes (``repro_torch.core.ranks``).  The rest of the reference's
``repro.parallel`` (``context``, ``rules``) is ROADMAP §1 item 11."""
from .ring_attention import ring_attention, ring_attention_plain

__all__ = ["ring_attention", "ring_attention_plain"]
