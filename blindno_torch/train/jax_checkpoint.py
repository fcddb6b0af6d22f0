"""The JAX package's checkpoint files, read with numpy, the standard library and ``ctypes``
alone: no JAX, flax, orbax, tensorstore, msgpack or zstandard.

Two formats (``blindno/train/checkpoint.py``):

- ``best_{loss:.6f}_e{epoch}``, a directory that orbax's ``StandardCheckpointer`` wrote:
  zarr v2 arrays, one per leaf, in an OCDBT key-value store (tensorstore's B-tree format:
  ``manifest.ocdbt`` at the root, its B-tree nodes under ``d/``, the values they point to
  in the data files under ``ocdbt.process_0/d/``). :func:`read_orbax` returns what
  ``StandardCheckpointer().restore`` returns: ``{"params", "batch_stats"}`` as nested
  dicts of numpy arrays, ``"epoch"`` an int and ``"test_loss"`` a float.
- ``resume.msgpack``, ``flax.serialization.to_bytes`` of ``{"params", "batch_stats",
  "opt_state", "epoch", "best_loss"}``. :func:`read_msgpack` returns that state dict,
  numpy arrays for flax's array and scalar extension types. JAX's optimizer is
  ``optax.adam(schedule)`` (``blindno/train/loop.py:316``), so ``opt_state`` is
  ``{"0": {"count", "mu", "nu"}, "1": {"count"}}``: Adam's and the schedule's.

zstd frames (the OCDBT manifests and nodes, and every zarr chunk) are decompressed by
the system's ``libzstd.so.1`` through ``ctypes``. Only what these files use is read: a
manifest of kind "single" whose version tree is inline, B-tree nodes of height 0, zarr
v2 arrays of one chunk compressed by zstd, in C order with no filters. Anything else, a
failed check of a magic, a length or a CRC-32C, or a missing library raises
:class:`JaxCheckpointError`, which names the file.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import json
import os
import struct

import numpy as np

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
ORBAX_FILES = ("_METADATA", "manifest.ocdbt")
ZARR_DTYPES = ("<f4", "<f8", "<i8")


class JaxCheckpointError(ValueError):
    """A JAX checkpoint this reader cannot read, or a library it needs is missing."""


@functools.cache
def zstd_library():
    """The system's zstd library, its three functions typed."""
    name = ctypes.util.find_library("zstd")
    if name is None:
        raise JaxCheckpointError(
            "libzstd.so.1 not found (ctypes.util.find_library('zstd')): the JAX package's "
            "checkpoints are zstd-compressed; install the system's zstd library (Debian and "
            "Ubuntu: libzstd1)")
    lib = ctypes.CDLL(name)
    lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
                                    ctypes.c_size_t]
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    return lib


def zstd_decompress(frame: bytes, size: int | None, what: str, limit: int = 0) -> np.ndarray:
    """The zstd ``frame`` decompressed, as bytes of a uint8 array, which must give
    ``size`` bytes. With ``size`` None (an OCDBT manifest or node), the size the frame's
    header states, or, where it states none, whatever it gives up to ``limit`` bytes: the
    buffer is left unwritten (``np.empty``), so only the pages it fills are touched."""
    lib = zstd_library()
    exact = size is not None
    if not exact:
        size = lib.ZSTD_getFrameContentSize(frame, len(frame))
        exact = size < 2 ** 64 - 2  # not ZSTD_CONTENTSIZE_UNKNOWN or _ERROR
        size = size if exact else limit
    out = np.empty(size, np.uint8)
    got = lib.ZSTD_decompress(out.ctypes.data, size, frame, len(frame))
    if lib.ZSTD_isError(got) or (exact and got != size):
        raise JaxCheckpointError(
            f"{what}: zstd gave {'an error' if lib.ZSTD_isError(got) else got} where "
            f"{size if exact else f'at most {limit}'} bytes were expected")
    return out if got == size else out[:got].copy()


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as OCDBT ends each manifest and node with it."""
    crc, table = 0xFFFFFFFF, _CRC32C
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Cursor:
    """Reads OCDBT's fields in order: bytes, varints, little-endian integers."""

    def __init__(self, buf, what):
        self.buf, self.pos, self.what = memoryview(buf), 0, what

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise JaxCheckpointError(f"{self.what}: truncated at byte {self.pos}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self):
        return self.take(1)[0]

    def varint(self):
        value = shift = 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7

    def varints(self, n):
        return [self.varint() for _ in range(n)]

    def prefixed(self, n):
        """``n`` byte strings, each stored as the length it shares with the one before,
        then all their suffix lengths, then the suffixes (OCDBT's keys and file paths)."""
        shared = [0] + self.varints(n - 1) if n else []
        suffix = self.varints(n)
        return shared, suffix

    def strings(self, shared, suffix):
        out, prev = [], b""
        for s, n in zip(shared, suffix):
            if s > len(prev):
                raise JaxCheckpointError(f"{self.what}: a prefix longer than the previous key")
            prev = prev[:s] + bytes(self.take(n))
            out.append(prev)
        return out

    def done(self):
        if self.pos != len(self.buf):
            raise JaxCheckpointError(f"{self.what}: {len(self.buf) - self.pos} bytes left over")


def _block(raw: bytes, magic: int, what: str, limit: int = 0) -> np.ndarray | bytes:
    """The body of an OCDBT manifest or node: magic, length, version 0 and compression
    checked, the trailing CRC-32C checked, the body decompressed (to at most ``limit``
    bytes where its frame states no size)."""
    if len(raw) < 18 or struct.unpack(">I", raw[:4])[0] != magic:
        kind = "manifest" if magic == MANIFEST_MAGIC else "node"
        raise JaxCheckpointError(f"{what}: not an OCDBT {kind} (magic {raw[:4].hex()})")
    if struct.unpack("<Q", raw[4:12])[0] != len(raw):
        raise JaxCheckpointError(f"{what}: its header says {struct.unpack('<Q', raw[4:12])[0]} "
                                 f"bytes, it has {len(raw)}")
    if crc32c(raw[:-4]) != struct.unpack("<I", raw[-4:])[0]:
        raise JaxCheckpointError(f"{what}: CRC-32C mismatch")
    head = _Cursor(raw[12:-4], what)
    version, compression = head.varint(), head.varint()
    if version != 0 or compression not in (0, 1):
        raise JaxCheckpointError(f"{what}: OCDBT version {version}, compression {compression}")
    body = bytes(head.take(len(head.buf) - head.pos))
    return zstd_decompress(body, None, what, limit) if compression else body


def _data_files(cur: _Cursor) -> list[str]:
    """OCDBT's data-file table: each file's path from the store's root."""
    n = cur.varint()
    shared, suffix = cur.prefixed(n)
    base = cur.varints(n)
    paths = [p.decode() for p in cur.strings(shared, suffix)]
    if any(b > len(p) for b, p in zip(base, paths)):
        raise JaxCheckpointError(f"{cur.what}: a base path longer than its file's path")
    return paths


def _root(directory: str) -> tuple[str, int, int, int]:
    """The newest version's root node in ``directory/manifest.ocdbt``: (file, offset,
    length), and the largest size of a decoded node."""
    what = os.path.join(directory, "manifest.ocdbt")
    with open(what, "rb") as f:
        cur = _Cursor(_block(f.read(), MANIFEST_MAGIC, what), what)
    cur.take(16)  # the store's uuid
    kind = cur.varint()
    cur.varint()  # max inline value bytes
    node_bytes = cur.varint()
    cur.byte()  # version tree arity (log 2)
    if cur.varint() == 1:
        cur.take(4)  # zstd level
    if kind != 0:
        raise JaxCheckpointError(f"{what}: manifest kind {kind} (only 'single', 0, is read)")
    files = _data_files(cur)
    n = cur.varint()
    generation = cur.varints(n)
    height = [cur.byte() for _ in range(n)]
    file_id, offset, length = cur.varints(n), cur.varints(n), cur.varints(n)
    cur.varints(n), cur.varints(n), cur.varints(n)  # keys, tree bytes, indirect value bytes
    cur.take(8 * n)  # commit times
    if cur.varint():
        raise JaxCheckpointError(f"{what}: a version tree with nodes outside the manifest")
    cur.done()
    if not n:
        raise JaxCheckpointError(f"{what}: no version")
    last = int(np.argmax(generation))
    if height[last]:
        raise JaxCheckpointError(f"{what}: a B-tree of height {height[last]} (only one leaf "
                                 "node is read)")
    return files[file_id[last]], offset[last], length[last], node_bytes


def read_ocdbt(directory: str) -> dict[str, bytes]:
    """Every key of the OCDBT store in ``directory`` and its value."""
    path, offset, length, node_bytes = _root(directory)
    what = os.path.join(directory, path)
    with open(what, "rb") as f:
        f.seek(offset)
        raw = f.read(length)
    if len(raw) != length:
        raise JaxCheckpointError(f"{what}: {len(raw)} bytes at {offset}, {length} expected")
    cur = _Cursor(_block(raw, NODE_MAGIC, what, node_bytes), what)
    if cur.byte():
        raise JaxCheckpointError(f"{what}: an interior B-tree node (one leaf node is read)")
    files = _data_files(cur)
    n = cur.varint()
    keys = [k.decode() for k in cur.strings(*cur.prefixed(n))]
    lengths = cur.varints(n)
    kinds = [cur.byte() for _ in range(n)]
    if set(kinds) - {0, 1}:
        raise JaxCheckpointError(f"{what}: value kinds {sorted(set(kinds))}")
    indirect = [i for i in range(n) if kinds[i] == 1]
    file_ids, offsets = cur.varints(len(indirect)), cur.varints(len(indirect))
    values = {keys[i]: bytes(cur.take(lengths[i])) for i in range(n) if kinds[i] == 0}
    cur.done()
    handles = {}
    try:
        for i, fid, off in zip(indirect, file_ids, offsets):
            if fid not in handles:
                handles[fid] = open(os.path.join(directory, files[fid]), "rb")
            handles[fid].seek(off)
            values[keys[i]] = handles[fid].read(lengths[i])
            if len(values[keys[i]]) != lengths[i]:
                raise JaxCheckpointError(f"{files[fid]}: value of {keys[i]!r} truncated")
    finally:
        for h in handles.values():
            h.close()
    return values


def _zarr_array(store: dict, name: str, what: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``store``: its ``.zarray`` and its one chunk."""
    try:
        meta = json.loads(store[f"{name}/.zarray"])
    except KeyError:
        raise JaxCheckpointError(f"{what}: no array {name!r} in the store") from None
    shape, dtype = tuple(meta["shape"]), meta["dtype"]
    if meta.get("zarr_format") != 2 or dtype not in ZARR_DTYPES or meta.get("order") != "C" \
            or meta.get("filters") or tuple(meta.get("chunks")) != shape \
            or (meta.get("compressor") or {}).get("id") != "zstd":
        raise JaxCheckpointError(f"{what}: array {name!r} is not a one-chunk zstd zarr v2 "
                                 f"array of {ZARR_DTYPES} in C order: {meta}")
    sep = meta.get("dimension_separator", ".")
    chunk = f"{name}/" + (sep.join("0" * len(shape)) if shape else "0")
    if chunk not in store:
        raise JaxCheckpointError(f"{what}: array {name!r} has no chunk {chunk!r}")
    dt = np.dtype(dtype)
    size = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
    return zstd_decompress(store[chunk], size, f"{what}: {chunk}").view(dt).reshape(shape)


def is_orbax(path: str) -> bool:
    """Whether ``path`` is a directory that orbax wrote with OCDBT."""
    return os.path.isdir(path) and all(os.path.isfile(os.path.join(path, f)) for f in ORBAX_FILES)


def read_orbax(directory: str) -> dict:
    """What ``orbax.checkpoint.StandardCheckpointer().restore(directory)`` returns for a
    ``best_*`` directory of the JAX package."""
    with open(os.path.join(directory, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3") or not meta.get("use_ocdbt"):
        raise JaxCheckpointError(f"{directory}: use_ocdbt={meta.get('use_ocdbt')}, "
                                 f"use_zarr3={meta.get('use_zarr3')} (OCDBT with zarr v2 is read)")
    with open(os.path.join(directory, "array_metadatas", "process_0")) as f:
        named = {a["array_metadata"]["param_name"] for a in json.load(f)["array_metadatas"]}
    store = read_ocdbt(directory)
    out, arrays = {}, set()
    for leaf in meta["tree_metadata"].values():
        path = [k["key"] for k in leaf["key_metadata"]]
        if any(k["key_type"] != 2 for k in leaf["key_metadata"]):
            raise JaxCheckpointError(f"{directory}: {path} is not a path of dict keys")
        kind = leaf["value_metadata"]["value_type"]
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        name = ".".join(path)
        if kind == "Dict":  # an empty dict
            node[path[-1]] = {}
        elif kind == "scalar":
            value = _zarr_array(store, name, directory)
            node[path[-1]] = int(value) if value.dtype.kind == "i" else float(value)
        elif kind in ("jax.Array", "np.ndarray"):
            node[path[-1]] = _zarr_array(store, name, directory)
            arrays.add(name)
        else:
            raise JaxCheckpointError(f"{directory}: leaf {name!r} of type {kind!r}")
    if arrays != named:
        raise JaxCheckpointError(f"{directory}: the tree's arrays and array_metadatas' "
                                 f"param_name differ: {sorted(arrays ^ named)[:4]}")
    return out


# ---- flax msgpack ---------------------------------------------------------------------

_FLAX_NDARRAY, _FLAX_NPSCALAR = 1, 3


class _Unpacker:
    """The msgpack that ``flax.serialization.to_bytes`` writes: maps, arrays, strings,
    binaries, integers, floats, nil and booleans, and flax's extension types for numpy
    arrays and scalars."""

    def __init__(self, buf, what):
        self.cur, self.what = _Cursor(buf, what), what

    def _n(self, fmt, size):
        return struct.unpack(fmt, self.cur.take(size))[0]

    def value(self):
        t = self.cur.byte()
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.value() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return bytes(self.cur.take(t & 0x1F)).decode()
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in fixed:
            return fixed[t]
        sizes = {0: (">B", 1), 1: (">H", 2), 2: (">I", 4)}
        if 0xC4 <= t <= 0xC6:  # bin 8/16/32
            return bytes(self.cur.take(self._n(*sizes[t - 0xC4])))
        if 0xC7 <= t <= 0xC9:  # ext 8/16/32
            n = self._n(*sizes[t - 0xC7])
            return self._ext(self._n(">b", 1), n)
        numbers = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1), 0xCD: (">H", 2),
                   0xCE: (">I", 4), 0xCF: (">Q", 8), 0xD0: (">b", 1), 0xD1: (">h", 2),
                   0xD2: (">i", 4), 0xD3: (">q", 8)}
        if t in numbers:
            return self._n(*numbers[t])
        if 0xD4 <= t <= 0xD8:  # fixext 1/2/4/8/16
            return self._ext(self._n(">b", 1), 1 << (t - 0xD4))
        if 0xD9 <= t <= 0xDB:  # str 8/16/32
            return bytes(self.cur.take(self._n(*sizes[t - 0xD9]))).decode()
        if t in (0xDC, 0xDD):
            return [self.value() for _ in range(self._n(*sizes[t - 0xDB]))]
        if t in (0xDE, 0xDF):
            return self._map(self._n(*sizes[t - 0xDD]))
        raise JaxCheckpointError(f"{self.what}: msgpack type byte {t:#x}")

    def _map(self, n):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def _ext(self, code, n):
        payload = bytes(self.cur.take(n))
        if code not in (_FLAX_NDARRAY, _FLAX_NPSCALAR):
            raise JaxCheckpointError(f"{self.what}: msgpack extension type {code}")
        shape, dtype, data = _Unpacker(payload, self.what).value()  # one array of three
        dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
        try:
            dt = np.dtype(dtype)
        except TypeError:
            raise JaxCheckpointError(f"{self.what}: an array of dtype {dtype!r}") from None
        arr = np.frombuffer(data, dt).reshape(shape)
        return arr[()] if code == _FLAX_NPSCALAR else arr


def read_msgpack(path: str) -> dict:
    """What ``flax.serialization.msgpack_restore`` returns for ``path``: the state dict
    that ``flax.serialization.to_bytes`` wrote, with numpy arrays."""
    with open(path, "rb") as f:
        raw = f.read()
    unpacker = _Unpacker(raw, path)
    out = unpacker.value()
    unpacker.cur.done()
    if not isinstance(out, dict):
        raise JaxCheckpointError(f"{path}: not a flax state dict")
    _refuse_chunked(out, path)
    return out


def _refuse_chunked(tree, path):
    """flax splits an array past 2**30 bytes into chunks; none of this package's are."""
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise JaxCheckpointError(f"{path}: a chunked array (over 1 GiB)")
        for v in tree.values():
            _refuse_chunked(v, path)
