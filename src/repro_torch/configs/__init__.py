"""Architecture registry of the port: ``--arch <id>`` resolves here.  The
port carries the dense architectures its serving path runs."""
from . import llama32_3b, qwen3_8b
from .base import ArchConfig

_MODULES = {
    "llama3.2-3b": llama32_3b,
    "qwen3-8b": qwen3_8b,
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    try:
        return _MODULES[arch_id]
    except KeyError:
        raise KeyError(f"architecture {arch_id!r} is not ported; the port "
                       f"has {list(ARCH_IDS)}") from None


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).smoke()


__all__ = ["ARCH_IDS", "ArchConfig", "get_config", "get_smoke_config"]
