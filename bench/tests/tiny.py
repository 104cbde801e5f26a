"""Tiny overrides of the cells' configuration and traffic files, for CPU
runs of the runners with the kernels' plain versions.  The tiny model
trains in float32: the cell's limits are set for bf16 at its published
widths, where a bf16 step's rounding is far smaller than at width 64."""
import copy

SW = {"config": {"database": {"subjects": 300, "mean_len": 60, "gamma_shape": 2.0,
                              "min_len": 2, "max_len": 120},
                 "chunk_subjects": 64},
      "traffic": {"query_lengths": [20, 40], "gap_regimes": [[10.0, 2.0], [5.0, 2.0]]}}

TRAIN = {"config": {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
                    "intermediate_size": 128, "num_hidden_layers": 2, "vocab_size": 256,
                    "sliding_window": 12,
                    "port_overrides": {"pad_heads_to": 0},
                    "training": {"param_dtype": "float32", "moment_dtype": "float32",
                                 "remat": True, "loss_chunk": 16,
                                 "optimizer": {"b1": 0.9, "b2": 0.95, "eps": 1e-08,
                                               "weight_decay": 0.1, "max_grad_norm": 1.0,
                                               "undecayed": ["final_norm"],
                                               "warmup_steps": 100, "min_ratio": 0.1,
                                               "total_steps": 100000}}},
         "traffic": {"batch": 2, "seq": 32}}

CELLS = {"sw-swissprot-search": SW, "sw-swissprot-long": SW, "phi3-train-4k": TRAIN}


def overrides(cell):
    return copy.deepcopy(CELLS[cell])
