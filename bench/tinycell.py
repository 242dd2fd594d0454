"""A cell of the manifest cut to a size the CPU runs in seconds: a
collection of 3,000 documents, a 2-layer LM of width 64 in float32, 20
topics a call.  Only the tests use it."""
from __future__ import annotations

import dataclasses
import json

import harness

COLLECTION = {"n_docs": 3000, "vocab": 4000, "mean_len": 60,
              "len_sigma": 0.5, "min_len": 8, "zipf_s": 1.07,
              "stop_df_fraction": 0.1}
LM = {"name": "tiny-lm", "n_layers": 2, "d_model": 64, "n_q": 4, "n_kv": 2,
      "d_head": 16, "d_ff": 128, "vocab": 512, "qkv_bias": True,
      "tie_embeddings": True, "rope_theta": 1e6, "norm_eps": 1e-6,
      "dtype": "float32", "attn_impl": "pallas"}


def tiny(name: str) -> harness.Cell:
    c = harness.Cell.load(name)
    conf = {**c.config, "collection": COLLECTION}
    spec = c.spec
    if "lm" in conf:
        conf["lm"] = LM
        spec = json.loads(json.dumps(spec).replace(
            c.config["lm"]["name"], LM["name"]).replace(
            "max_prompt_len=1024", "max_prompt_len=64").replace(
            "max_new_tokens=32", "max_new_tokens=4"))
    tr = {**c.traffic}
    tr["topics_per_call"] = 20
    return dataclasses.replace(c, config=conf, spec=spec, traffic=tr)
