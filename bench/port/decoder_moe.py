"""A decoder with sparse experts (reference/decoder_moe.py) on the port's
DecoderConfig: one superblock of attention and an MoE feed forward of
gated experts, no QK norm, no softcaps, no QKV bias, no multipliers."""
from bench.port import require

# the configuration file's keys and the port's config fields they set
FIELDS = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
          "num_attention_heads": "n_heads",
          "num_key_value_heads": "n_kv_heads",
          "intermediate_size": "d_ff", "vocab_size": "vocab",
          "num_local_experts": "n_experts",
          "num_experts_per_tok": "top_k",
          "capacity_factor": "capacity_factor",
          "rope_theta": "rope_theta",
          "tie_word_embeddings": "tie_embeddings"}


def fields(conf: dict) -> dict:
    kw = {f: conf[k] for k, f in FIELDS.items() if k in conf}
    kw["head_dim"] = conf["hidden_size"] // conf["num_attention_heads"]
    return kw


def check(conf: dict, cfg) -> None:
    require(conf, {"rms_norm_eps": 1e-6, "embedding_multiplier": 1.0,
                   "attention_multiplier": cfg.resolved_head_dim ** -0.5,
                   "residual_multiplier": 1.0, "logits_scaling": 1.0,
                   "router_aux_loss_coef": 0.01})
    if cfg.superblock != (("attn", "moe"),) or cfg.qkv_bias \
            or cfg.qk_norm or cfg.scale_embeds or cfg.final_softcap \
            or cfg.attn_softcap or not cfg.gated_mlp \
            or cfg.activation != conf["hidden_act"]:
        raise ValueError(f"{conf['port_arch']}: the port's decoder is "
                         f"not the one the configuration states")
