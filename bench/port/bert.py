"""BERT (reference/bert.py) on the port's BertConfig."""
from bench.port import require

# the configuration file's keys and the port's config fields they set
FIELDS = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
          "num_attention_heads": "n_heads", "intermediate_size": "d_ff",
          "vocab_size": "vocab", "max_position_embeddings": "max_pos",
          "type_vocab_size": "type_vocab"}


def fields(conf: dict) -> dict:
    return {f: conf[k] for k, f in FIELDS.items() if k in conf}


def check(conf: dict, cfg) -> None:
    require(conf, {"layer_norm_eps": 1e-6})
