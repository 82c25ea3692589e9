"""DataFeedDesc: input-format descriptor for the dataset path.

Counterpart of ``paddle_tpu/data_feed_desc.py``, the same parse and the
same prototext dump.

Reference parity: python/paddle/fluid/data_feed_desc.py:21, backed by
paddle/fluid/framework/data_feed.proto (name, batch_size, pipe_command,
multi_slot_desc.slots{name,type,is_dense,is_used}).

The reference parses the on-disk description with protobuf text_format; the
wire format here is the same prototext (so reference .proto files load
unchanged) parsed by a small self-contained reader — no protobuf runtime
needed for a config this shape.
"""

from __future__ import annotations

import re

__all__ = ["DataFeedDesc"]

_TOKEN = re.compile(r'"[^"]*"|[{}]|[^\s{}]+')


class _Msg(dict):
    """Nested dict with repeated-field lists."""

    def add(self, key, value):
        if key in self and not isinstance(self[key], list):
            self[key] = [self[key]]
        if isinstance(self.get(key), list):
            self[key].append(value)
        else:
            self[key] = value


def _parse_prototext(text):
    tokens = _TOKEN.findall(re.sub(r"#.*", "", text))
    pos = 0

    def value(tok):
        if tok.startswith('"'):
            return tok[1:-1]
        if tok in ("true", "false"):
            return tok == "true"
        try:
            return int(tok)
        except ValueError:
            try:
                return float(tok)
            except ValueError:
                return tok

    def parse_msg(depth):
        nonlocal pos
        msg = _Msg()
        while pos < len(tokens):
            tok = tokens[pos]
            if tok == "}":
                pos += 1
                return msg
            key = tok.rstrip(":")
            pos += 1
            if pos < len(tokens) and tokens[pos] == "{":
                pos += 1
                msg.add(key, parse_msg(depth + 1))
            else:
                msg.add(key, value(tokens[pos]))
                pos += 1
        if depth:
            raise ValueError("unbalanced braces in data feed prototext")
        return msg

    return parse_msg(0)


def _as_list(v):
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


class DataFeedDesc:
    """reference data_feed_desc.py:21.  Load a MultiSlotDataFeed prototext,
    tweak it (set_batch_size / set_dense_slots / set_use_slots), dump it
    back with desc()."""

    def __init__(self, proto_file):
        with open(proto_file, "r") as f:
            self.proto_desc = _parse_prototext(f.read())
        self.proto_desc.setdefault("pipe_command", "cat")
        self.__name_to_index = {}
        if self.proto_desc.get("name") == "MultiSlotDataFeed":
            self.__name_to_index = {
                slot["name"]: i for i, slot in enumerate(self._slots())}

    def _slots(self):
        msd = self.proto_desc.get("multi_slot_desc") or _Msg()
        return _as_list(msd.get("slots"))

    def set_batch_size(self, batch_size):
        self.proto_desc["batch_size"] = int(batch_size)

    def set_dense_slots(self, dense_slots_name):
        if not self.__name_to_index:
            raise ValueError(
                "Only MultiSlotDataFeed needs set_dense_slots, please check "
                "your datafeed.proto")
        slots = self._slots()
        for name in dense_slots_name:
            slots[self.__name_to_index[name]]["is_dense"] = True

    def set_use_slots(self, use_slots_name):
        if not self.__name_to_index:
            raise ValueError(
                "Only MultiSlotDataFeed needs set_use_slots, please check "
                "your datafeed.proto")
        slots = self._slots()
        for name in use_slots_name:
            slots[self.__name_to_index[name]]["is_used"] = True

    def desc(self):
        """Prototext dump (round-trips through _parse_prototext)."""

        def emit(msg, indent):
            pad = "  " * indent
            out = []
            for key, val in msg.items():
                for v in _as_list(val):
                    if isinstance(v, _Msg) or isinstance(v, dict):
                        out.append(f"{pad}{key} {{")
                        out.extend(emit(v, indent + 1))
                        out.append(f"{pad}}}")
                    elif isinstance(v, bool):
                        out.append(f"{pad}{key}: {'true' if v else 'false'}")
                    elif isinstance(v, str):
                        out.append(f'{pad}{key}: "{v}"')
                    else:
                        out.append(f"{pad}{key}: {v}")
            return out

        return "\n".join(emit(self.proto_desc, 0)) + "\n"

    # convenience accessors used by the dataset/executor integration
    def batch_size(self):
        return int(self.proto_desc.get("batch_size", 1))

    def used_slots(self):
        return [s["name"] for s in self._slots() if s.get("is_used")]
