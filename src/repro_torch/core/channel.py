"""Channel base class — LOCO §4.1/§4.2, the counterpart of
``repro/core/channel.py``.

Channels are **named** (endpoints with matching names connect) and
**composable** (sub-channels are namespaced under their parent with '/';
component memory regions with '.').  Every participant builds the same
channel tree, so the join/connect handshake reduces to registration-time
checking; the naming, namespacing, region declaration and membership count
are kept because the memory ledger and the kvstore depend on them.
"""
from __future__ import annotations

from typing import Dict, Optional

from .runtime import Manager


class Channel:
    """Base class for channel objects.

    Concrete channels hold static configuration only; all dynamic state lives
    in an explicit NamedTuple of tensors led by the participants held here
    (``n_local``), returned by ``init_state()`` and threaded through the
    channel's methods."""

    def __init__(self, parent: Optional["Channel"], name: str, mgr: Manager,
                 expect_num: Optional[int] = None):
        if "/" in name or "." in name:
            raise ValueError(f"channel name {name!r} may not contain '/' or '.'")
        self.name = name
        self.parent = parent
        self.mgr = mgr
        # LOCO's expect_num: how many peers must join before ready; all P
        # participants join by construction, so a mismatch is a config bug
        self.expect_num = mgr.P if expect_num is None else int(expect_num)
        if self.expect_num != mgr.P:
            raise ValueError(
                f"channel {name!r} expects {self.expect_num} participants "
                f"but the runtime has {mgr.P} (join would never complete)")
        self._subchannels: Dict[str, "Channel"] = {}
        if parent is not None:
            parent._subchannels[name] = self
        mgr.register_channel(self.full_name, self)

    @property
    def full_name(self) -> str:
        if self.parent is None:
            return self.name
        return f"{self.parent.full_name}/{self.name}"

    def subchannel(self, name: str) -> "Channel":
        return self._subchannels[name]

    def declare_region(self, name: str, shape, dtype):
        """Declare a named component memory region ('<channel>.<region>')."""
        return self.mgr.register_region(f"{self.full_name}.{name}", shape,
                                        dtype)

    @property
    def P(self) -> int:
        """The cluster's participant count."""
        return self.mgr.P

    @property
    def n_local(self) -> int:
        """The participants held here: the leading dimension of every state
        and lane tensor (P stacked, 1 a rank)."""
        return self.mgr.n_local

    @property
    def rt(self):
        """The runtime: the binding the collectives go through."""
        return self.mgr.runtime

    @property
    def device(self):
        return self.mgr.device

    def my_id(self):
        """(n_local,) global participant ids."""
        return self.mgr.runtime.my_id()

    def local_ids(self):
        """(n_local,) positions on the leading dimension."""
        return self.mgr.runtime.local_ids()

    def __repr__(self):
        return f"<{type(self).__name__} {self.full_name!r} P={self.P}>"
