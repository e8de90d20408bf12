"""A copy of the benchmark's files with both cells cut to a size the CPU
runs in seconds: the same files, drivers, readers and limits, smaller
numbers."""
import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY = {
    "configs/bert_large.json": {
        "num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
        "intermediate_size": 128, "vocab_size": 500,
        "padded_vocab_size": 512,
        "max_position_embeddings": 64},
    "workloads/bert_large.pretrain_s512.json": {
        "mix": {"batch": 4, "seq_len": 64, "token_ids": 500,
                "reference_chunk": 2, "pool": 4}},
    "configs/resnet50.json": {"layers": [1, 1, 1, 1], "width_per_group": 8,
                              "num_classes": 10, "image_size": 64},
    "workloads/resnet50.o2_b256.json": {"mix": {"batch": 8}},
}


def tiny_checkout(dest) -> Path:
    dest = Path(dest)
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"),
                    dirs_exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for rel, new in TINY.items():
        path = dest / "perfbench" / rel
        data = json.loads(path.read_text())
        for k, v in new.items():
            if isinstance(v, dict):
                data[k].update(v)
            else:
                data[k] = v
        path.write_text(json.dumps(data))
    return dest
