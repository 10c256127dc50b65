"""Serving demo, the counterpart of ``examples/serve_demo.py``: continuous
batching with the channel-based page table (SharedQueue admission +
KVStore paged-KV bookkeeping) through the port's serve launcher
(``repro_torch.launch.serve``), with the reference demo's arguments.

  PYTHONPATH=src python -m repro_torch.examples.serve_demo --device cpu

``--device`` defaults to the card; arguments given here follow the demo's
own, so they override them (``--requests 4``).
"""
import sys

from repro_torch.launch import serve as serve_launcher

DEMO_ARGS = ["--arch", "qwen3-8b", "--smoke", "--requests", "8",
             "--prompt-len", "24", "--gen-len", "8", "--max-batch", "4"]


def main(argv=None):
    return serve_launcher.main(
        DEMO_ARGS + (sys.argv[1:] if argv is None else list(argv)))


if __name__ == "__main__":
    main()
