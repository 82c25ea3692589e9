"""Native runtime: C++ blocking queue, MultiSlot parser, recordio, shell.

Counterpart of ``paddle_tpu/native/`` (its ``predictor.cc``, the C-ABI
predictor, is not ported: ROADMAP Queue 1 item 6).  The port keeps its
own copy of the sources (``native/src/``), compiled with ``g++`` by
``_build.build_host()`` at the first use of a class here, into
``_build/libpt_native-<digest>.so``, and loaded with ``ctypes``.  Where
no C++ compiler is found a pure-Python fallback with the same classes
keeps every feature working (slower parse path only).

Reference parity (SURVEY.md §2.1/§2.8): framework/blocking_queue.h +
channel.h, framework/data_feed.cc (MultiSlotDataFeed), recordio/,
framework/io/shell.cc.

``NATIVE`` tells callers which implementation is live; reading it
builds the library if it is not built yet.
"""

from __future__ import annotations

import ctypes
import queue as _pyqueue
import struct
import subprocess
import threading
import zlib

import numpy as np

_state = {"lib": None, "tried": False}
_state_lock = threading.Lock()


def _declare(lib):
    lib.pt_free.argtypes = [ctypes.c_void_p]
    lib.pt_queue_create.restype = ctypes.c_void_p
    lib.pt_queue_create.argtypes = [ctypes.c_size_t]
    lib.pt_queue_destroy.argtypes = [ctypes.c_void_p]
    lib.pt_queue_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_size_t]
    lib.pt_queue_pop.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_void_p),
                                 ctypes.POINTER(ctypes.c_size_t)]
    lib.pt_queue_size.restype = ctypes.c_size_t
    lib.pt_queue_size.argtypes = [ctypes.c_void_p]
    lib.pt_queue_close.argtypes = [ctypes.c_void_p]
    lib.pt_queue_is_closed.argtypes = [ctypes.c_void_p]
    lib.pt_recordio_writer_open.restype = ctypes.c_void_p
    lib.pt_recordio_writer_open.argtypes = [ctypes.c_char_p]
    lib.pt_recordio_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_size_t]
    lib.pt_recordio_writer_close.argtypes = [ctypes.c_void_p]
    lib.pt_recordio_scanner_open.restype = ctypes.c_void_p
    lib.pt_recordio_scanner_open.argtypes = [ctypes.c_char_p]
    lib.pt_recordio_next.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.POINTER(ctypes.c_size_t)]
    lib.pt_recordio_scanner_close.argtypes = [ctypes.c_void_p]
    lib.pt_multislot_parse.restype = ctypes.c_int64
    lib.pt_multislot_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_longlong)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_longlong)),
    ]
    lib.pt_shell_open.restype = ctypes.c_void_p
    lib.pt_shell_open.argtypes = [ctypes.c_char_p]
    lib.pt_shell_read.restype = ctypes.c_int64
    lib.pt_shell_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int64]
    lib.pt_shell_close.argtypes = [ctypes.c_void_p]
    return lib


def _load():
    """The loaded library, built on the first call; None where it cannot
    be built or loaded (the classes then run their Python fallback)."""
    with _state_lock:
        if not _state["tried"]:
            _state["tried"] = True
            from paddle_tpu_torch import _build

            try:
                _state["lib"] = _declare(ctypes.CDLL(
                    str(_build.build_host())))
            except (OSError, RuntimeError):
                _state["lib"] = None
        return _state["lib"]


def __getattr__(name):
    if name == "NATIVE":
        return _load() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# ---------------------------------------------------------------------------
# BlockingQueue
# ---------------------------------------------------------------------------

class BlockingQueue:
    """Bounded byte-record queue (reference blocking_queue.h)."""

    def __init__(self, capacity=64):
        self._lib = _load()
        if self._lib is not None:
            self._h = self._lib.pt_queue_create(capacity)
        else:
            self._q = _pyqueue.Queue(maxsize=capacity)
            self._closed = False

    def push(self, data: bytes) -> bool:
        if self._lib is not None:
            return bool(self._lib.pt_queue_push(self._h, data, len(data)))
        while True:
            if self._closed:
                return False
            try:
                self._q.put(data, timeout=0.1)
                return True
            except _pyqueue.Full:
                continue

    def pop(self):
        """bytes, or None when closed and drained."""
        if self._lib is not None:
            out = ctypes.c_void_p()
            n = ctypes.c_size_t()
            if not self._lib.pt_queue_pop(self._h, ctypes.byref(out),
                                          ctypes.byref(n)):
                return None
            data = ctypes.string_at(out, n.value)
            self._lib.pt_free(out)
            return data
        while True:
            try:
                return self._q.get(timeout=0.1)
            except _pyqueue.Empty:
                if self._closed:
                    return None

    def size(self):
        if self._lib is not None:
            return self._lib.pt_queue_size(self._h)
        return self._q.qsize()

    def close(self):
        if self._lib is not None:
            self._lib.pt_queue_close(self._h)
        else:
            self._closed = True

    def __del__(self):
        if getattr(self, "_lib", None) is not None and \
                getattr(self, "_h", None):
            self._lib.pt_queue_close(self._h)
            self._lib.pt_queue_destroy(self._h)
            self._h = None


# ---------------------------------------------------------------------------
# RecordIO
# ---------------------------------------------------------------------------

_PY_MAGIC = 0x50544152
_PY_CHUNK = 1 << 20


class RecordIOWriter:
    """Chunked record file writer (reference recordio/writer.h)."""

    def __init__(self, path):
        self._lib = _load()
        self._path = path
        if self._lib is not None:
            self._h = self._lib.pt_recordio_writer_open(path.encode())
            if not self._h:
                raise IOError(f"cannot open {path}")
        else:
            self._f = open(path, "wb")
            self._buf = bytearray()
            self._n = 0

    def write(self, data: bytes):
        if self._lib is not None:
            self._lib.pt_recordio_write(self._h, data, len(data))
            return
        self._buf += struct.pack("<I", len(data)) + data
        self._n += 1
        if len(self._buf) >= _PY_CHUNK:
            self._flush()

    def _flush(self):
        if not self._n:
            return
        payload = bytes(self._buf)
        self._f.write(struct.pack("<IIIII", _PY_MAGIC, 0, self._n,
                                  len(payload),
                                  zlib.crc32(payload) & 0xFFFFFFFF))
        self._f.write(payload)
        self._buf = bytearray()
        self._n = 0

    def close(self):
        if self._lib is not None:
            if self._h:
                self._lib.pt_recordio_writer_close(self._h)
                self._h = None
        else:
            self._flush()
            self._f.close()


class RecordIOScanner:
    """Iterates records of a RecordIO file (reference recordio/scanner.h)."""

    def __init__(self, path):
        self._lib = _load()
        if self._lib is not None:
            self._h = self._lib.pt_recordio_scanner_open(path.encode())
            if not self._h:
                raise IOError(f"cannot open {path}")
        else:
            self._f = open(path, "rb")
            self._records = []
            self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._lib is not None:
            out = ctypes.c_void_p()
            n = ctypes.c_size_t()
            if not self._lib.pt_recordio_next(
                    self._h, ctypes.byref(out), ctypes.byref(n)):
                raise StopIteration
            data = ctypes.string_at(out, n.value)
            self._lib.pt_free(out)
            return data
        while self._i >= len(self._records):
            head = self._f.read(20)
            if len(head) < 20:
                raise StopIteration
            magic, _, nrec, plen, crc = struct.unpack("<IIIII", head)
            if magic != _PY_MAGIC:
                raise StopIteration
            payload = self._f.read(plen)
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                raise StopIteration
            recs, off = [], 0
            for _ in range(nrec):
                (ln,) = struct.unpack_from("<I", payload, off)
                off += 4
                recs.append(payload[off:off + ln])
                off += ln
            self._records, self._i = recs, 0
        r = self._records[self._i]
        self._i += 1
        return r

    def close(self):
        if self._lib is not None:
            if self._h:
                self._lib.pt_recordio_scanner_close(self._h)
                self._h = None
        else:
            self._f.close()


# ---------------------------------------------------------------------------
# MultiSlot parser
# ---------------------------------------------------------------------------

class MultiSlotParser:
    """Parses the reference MultiSlotDataFeed text format
    (framework/data_feed.cc): per line, for each slot in schema order,
    "<num> <v1> ... <vnum>".  Returns per-slot (values, lod) where lod is
    the [n_lines+1] offset array (the LoD/segment boundaries)."""

    def __init__(self, slot_types):
        """slot_types: list of 'float' | 'int64' (one per slot)."""
        self._lib = _load()
        self._types = list(slot_types)
        for t in self._types:
            if t not in ("float", "int64"):
                raise ValueError(f"bad slot type {t}")

    def parse(self, text):
        """text: str|bytes of newline-separated samples.
        Returns (n_lines, [(values ndarray, lod ndarray int64)])."""
        if isinstance(text, str):
            text = text.encode()
        ns = len(self._types)
        if self._lib is not None:
            is_f = (ctypes.c_int * ns)(
                *[1 if t == "float" else 0 for t in self._types])
            fv = (ctypes.POINTER(ctypes.c_float) * ns)()
            iv = (ctypes.POINTER(ctypes.c_longlong) * ns)()
            ld = (ctypes.POINTER(ctypes.c_longlong) * ns)()
            n = self._lib.pt_multislot_parse(text, len(text), ns, is_f,
                                             fv, iv, ld)
            if n < 0:
                raise ValueError("malformed MultiSlot input")
            out = []
            for s in range(ns):
                lod = np.ctypeslib.as_array(ld[s], shape=(n + 1,)).copy()
                cnt = int(lod[-1])
                if self._types[s] == "float":
                    vals = np.ctypeslib.as_array(
                        fv[s], shape=(cnt,)).copy() if cnt else \
                        np.empty(0, np.float32)
                    self._lib.pt_free(fv[s])
                else:
                    vals = np.ctypeslib.as_array(
                        iv[s], shape=(cnt,)).copy().astype(np.int64) \
                        if cnt else np.empty(0, np.int64)
                    self._lib.pt_free(iv[s])
                self._lib.pt_free(ld[s])
                out.append((vals, lod.astype(np.int64)))
            return int(n), out
        # -- pure python fallback --
        vals = [[] for _ in range(ns)]
        lods = [[0] for _ in range(ns)]
        n = 0
        for line in text.decode().splitlines():
            toks = line.split()
            if not toks:
                continue
            i = 0
            for s in range(ns):
                if i >= len(toks):
                    raise ValueError("malformed MultiSlot input")
                cnt = int(float(toks[i]))
                i += 1
                vals[s].extend(toks[i:i + cnt])
                if len(toks[i:i + cnt]) != cnt:
                    raise ValueError("malformed MultiSlot input")
                i += cnt
                lods[s].append(len(vals[s]))
            n += 1
        out = []
        for s in range(ns):
            dt = np.float32 if self._types[s] == "float" else np.int64
            out.append((np.asarray(vals[s], dtype=np.float64).astype(dt),
                        np.asarray(lods[s], np.int64)))
        return n, out


# ---------------------------------------------------------------------------
# Shell / pipe_command reader
# ---------------------------------------------------------------------------

class ShellReader:
    """Reads a command's stdout (pipe_command preprocessing, reference
    framework/io/shell.cc + Dataset pipe_command)."""

    def __init__(self, cmd):
        self._lib = _load()
        if self._lib is not None:
            self._h = self._lib.pt_shell_open(cmd.encode())
            if not self._h:
                raise IOError(f"popen failed: {cmd}")
        else:
            self._p = subprocess.Popen(cmd, shell=True,
                                       stdout=subprocess.PIPE)

    def read_all(self) -> bytes:
        chunks = []
        if self._lib is not None:
            buf = ctypes.create_string_buffer(1 << 16)
            while True:
                n = self._lib.pt_shell_read(self._h, buf, len(buf))
                if n <= 0:
                    break
                chunks.append(buf.raw[:n])
            self._lib.pt_shell_close(self._h)
            self._h = None
        else:
            chunks.append(self._p.stdout.read())
            self._p.wait()
        return b"".join(chunks)
