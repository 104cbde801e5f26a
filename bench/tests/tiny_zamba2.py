"""A tiny override of the Zamba2 cell's configuration and traffic files,
for CPU runs of its runner with the kernels' plain versions: 12 layers
(the published pattern's first two hybrids), 2 memory blocks, 2 B/C
groups, adapter rank 8.  It trains in float32, as `tiny.TRAIN` does."""
import copy

from bench.tests import tiny

CELL = "zamba2-train-4k"

ZAMBA2 = {"config": {"hidden_size": 64, "attention_hidden_size": 128, "attention_head_dim": 32,
                     "num_attention_heads": 4, "num_key_value_heads": 4,
                     "intermediate_size": 128, "ffn_hidden_size": 128, "num_hidden_layers": 12,
                     "vocab_size": 256, "n_mamba_heads": 8, "mamba_headdim": 16,
                     "mamba_d_state": 16, "chunk_size": 8, "adapter_rank": 8,
                     "training": copy.deepcopy(tiny.TRAIN["config"]["training"])},
          "traffic": {"batch": 2, "seq": 32}}


def overrides(cell=CELL):
    assert cell == CELL, cell
    return copy.deepcopy(ZAMBA2)
