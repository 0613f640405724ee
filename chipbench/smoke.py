"""A cell of the manifest cut to a size the CPU runs in a second, for the
benchmark's own tests: the same files, traffic kind and limits, with
widths, depth, vocabulary and rows made small."""

from __future__ import annotations

import copy

from chipbench import harness

SMOKE_WIDTHS = dict(hidden_size=64, num_attention_heads=4,
                    num_key_value_heads=4, head_dim=16,
                    intermediate_size=128, vocab_size=503)


def smoke_cell(name: str, manifest: dict | None = None) -> harness.Cell:
    cell = harness.Cell(manifest or harness.load_manifest(), name)
    cfg = copy.deepcopy(cell.config)
    cfg.update(SMOKE_WIDTHS)
    if cfg.get("deq", {}).get("enabled"):
        cfg["num_hidden_layers"] = 2
        cfg["deq"]["max_steps"] = 6
    else:
        cfg["num_hidden_layers"] = 2
    cell.config = cfg
    cell.traffic = dict(cell.traffic, batch=4, seq=16, trace_seconds=0.2)
    return cell
