"""Param->pserver placement policies.

Counterpart of ``paddle_tpu/transpiler/ps_dispatcher.py``: the same
placement for the same params, so trainers and pservers of either
package agree on the plan (reference:
python/paddle/fluid/transpiler/ps_dispatcher.py:46 HashName, :80
RoundRobin)."""

from __future__ import annotations


class PSDispatcher:
    def __init__(self, pserver_endpoints):
        self._eplist = list(pserver_endpoints)

    @property
    def eplist(self):
        return self._eplist

    def dispatch(self, varlist):
        raise NotImplementedError

    def reset(self):
        pass


class HashName(PSDispatcher):
    """Stable name-hash placement (reference ps_dispatcher.py:46).
    Uses a deterministic digest — Python's salted hash() would give each
    process a different plan, but every trainer AND pserver must compute
    the identical placement independently."""

    def _hash_block(self, block_str, total):
        import hashlib

        digest = hashlib.md5(str(block_str).encode()).hexdigest()
        return int(digest, 16) % total

    def dispatch(self, varlist):
        eplist = []
        for var in varlist:
            name = var.name() if callable(getattr(var, "name", None)) \
                else str(getattr(var, "name", var))
            eplist.append(
                self._eplist[self._hash_block(name, len(self._eplist))])
        return eplist


class RoundRobin(PSDispatcher):
    """reference ps_dispatcher.py:80."""

    def __init__(self, pserver_endpoints):
        super().__init__(pserver_endpoints)
        self._step = 0

    def dispatch(self, varlist):
        eplist = []
        for _ in varlist:
            eplist.append(self._eplist[self._step])
            self._step = (self._step + 1) % len(self._eplist)
        return eplist

    def reset(self):
        self._step = 0
