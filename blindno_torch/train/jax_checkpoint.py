"""The JAX package's checkpoint files, read and written with numpy, the standard library
and ``ctypes`` alone: no JAX, flax, orbax, tensorstore, msgpack or zstandard.

Two formats (``blindno/train/checkpoint.py``):

- ``best_{loss:.6f}_e{epoch}``, a directory that orbax's ``StandardCheckpointer`` wrote:
  zarr v2 arrays, one per leaf, in an OCDBT key-value store (tensorstore's B-tree format:
  ``manifest.ocdbt`` at the root, its B-tree nodes under ``d/``, the values they point to
  in the data files under ``ocdbt.process_0/d/``). :func:`read_orbax` returns what
  ``StandardCheckpointer().restore`` returns: ``{"params", "batch_stats"}`` as nested
  dicts of numpy arrays, ``"epoch"`` an int and ``"test_loss"`` a float.
  :func:`write_orbax` writes such a directory.
- ``resume.msgpack``, ``flax.serialization.to_bytes`` of ``{"params", "batch_stats",
  "opt_state", "epoch", "best_loss"}``. :func:`read_msgpack` returns that state dict,
  numpy arrays for flax's array and scalar extension types, and :func:`write_msgpack`
  writes one. JAX's optimizer is ``optax.adam(schedule)``
  (``blindno/train/loop.py:316``), so ``opt_state`` is ``{"0": {"count", "mu", "nu"},
  "1": {"count"}}``: Adam's and the schedule's.

zstd frames (the OCDBT manifests and nodes, and every zarr chunk) are compressed and
decompressed by the system's ``libzstd.so.1`` through ``ctypes``. Only what these files
use is read: a manifest of kind "single" whose version tree is inline, B-tree nodes of
height 0, zarr v2 arrays of one chunk compressed by zstd, in C order with no filters.
Anything else, a failed check of a magic, a length or a CRC-32C, or a missing library
raises :class:`JaxCheckpointError`, which names the file.

What :func:`write_orbax` writes differs from orbax's own output in its store's layout
only, and both orbax (``StandardCheckpointer().restore``) and :func:`read_orbax` read
it: orbax writes each process's arrays into a store of its own under
``ocdbt.process_0/`` and then a root store whose node points into it; the writer
writes the root store alone, one data file ``d/<hex>`` holding every value longer than
the inline limit and, after them, the one leaf node. Its zstd frames state their
content size, which tensorstore's leave out. The metadata files (``_METADATA``,
``_sharding`` with a one-device ``NamedSharding``, ``array_metadatas/process_0``,
``_CHECKPOINT_METADATA``) and each array's ``.zarray`` are orbax's, field for field.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import json
import base64
import os
import struct
import time
import uuid

import numpy as np

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
ORBAX_FILES = ("_METADATA", "manifest.ocdbt")
ZARR_DTYPES = ("<f4", "<f8", "<i8")


class JaxCheckpointError(ValueError):
    """A JAX checkpoint this reader cannot read, or a library it needs is missing."""


@functools.cache
def zstd_library():
    """The system's zstd library, its five functions typed."""
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
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                  ctypes.c_size_t, ctypes.c_int]
    lib.ZSTD_compress.restype = ctypes.c_size_t
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


def zstd_compress(data, level: int, what: str) -> bytes:
    """``data`` (bytes, or a C-contiguous array's buffer) as one zstd frame at ``level``
    (0: zstd's default), its content size in the header."""
    lib = zstd_library()
    src = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data.reshape(-1).view(np.uint8)
    out = np.empty(lib.ZSTD_compressBound(src.size), np.uint8)
    got = lib.ZSTD_compress(out.ctypes.data, out.size, src.ctypes.data, src.size, level)
    if lib.ZSTD_isError(got):
        raise JaxCheckpointError(f"{what}: zstd could not compress {src.size} bytes")
    return out[:got].tobytes()


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



# ---- writing orbax's directories ------------------------------------------------------

ORBAX_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                 "StandardCheckpointHandler")
# orbax's OCDBT configuration, as its manifests state it: values up to MAX_INLINE_BYTES
# sit in their B-tree node, and a decoded node may hold MAX_NODE_BYTES
MAX_INLINE_BYTES, MAX_NODE_BYTES = 1024, 100_000_000
ZARR_ZSTD_LEVEL = 1  # the level orbax's .zarray files state
ONE_DEVICE = json.dumps({"sharding_type": "NamedSharding", "shape": [1], "axis_names": ["data"],
                         "axis_types": ["AxisType.Auto"], "partition_spec": [],
                         "device_mesh": {"mesh": [{"id": 0}]}})


def _varint(n: int) -> bytes:
    out = bytearray()
    while n > 0x7F:
        out.append(n & 0x7F | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _prefix_coded(strings: list[bytes]) -> tuple[bytes, bytes, bytes]:
    """OCDBT's coding of sorted byte strings, as :meth:`_Cursor.prefixed` reads it: the
    length each shares with the one before (from the second on), the suffixes' lengths,
    and the suffixes."""
    shared, suffixes, prev = [], [], b""
    for s in strings:
        n, limit = 0, min(len(s), len(prev))
        while n < limit and s[n] == prev[n]:
            n += 1
        shared.append(n)
        suffixes.append(s[n:])
        prev = s
    return _varints(shared[1:]), _varints(len(s) for s in suffixes), b"".join(suffixes)


def _data_file_table(paths: list[bytes]) -> bytes:
    """OCDBT's data-file table of ``paths``, each relative to the store's root (base
    path length 0)."""
    shared, suffix, text = _prefix_coded(paths)
    return _varint(len(paths)) + shared + suffix + _varints([0] * len(paths)) + text


def _encoded_block(magic: int, body: bytes, what: str) -> bytes:
    """An OCDBT manifest or node: magic, length, version 0, zstd, the compressed body
    and the CRC-32C of all before it (what :func:`_block` checks)."""
    payload = _varint(0) + _varint(1) + zstd_compress(body, 0, what)
    raw = struct.pack(">I", magic) + struct.pack("<Q", 12 + len(payload) + 4) + payload
    return raw + struct.pack("<I", crc32c(raw))


def write_ocdbt(directory: str, store: dict[str, bytes]):
    """An OCDBT store in ``directory`` (which must exist) holding ``store``'s keys and
    values, as :func:`read_ocdbt` and tensorstore read it: ``manifest.ocdbt`` and one data
    file under ``d/`` holding the values longer than MAX_INLINE_BYTES, then the one leaf
    node of the B-tree, which holds every key and the shorter values."""
    keys = sorted(k.encode() for k in store)
    values = [store[k.decode()] for k in keys]
    indirect = [len(v) > MAX_INLINE_BYTES for v in values]
    offsets = np.cumsum([0] + [len(v) for v, i in zip(values, indirect) if i]).tolist()
    data_path = f"d/{uuid.uuid4().hex}".encode()
    path = os.path.join(directory, data_path.decode())
    shared, suffix, text = _prefix_coded(keys)
    node = _encoded_block(NODE_MAGIC, b"".join((
        b"\0",  # height 0: a leaf
        _data_file_table([data_path] if any(indirect) else []),
        _varint(len(keys)), shared, suffix, text,
        _varints(len(v) for v in values), bytes(indirect),
        _varints([0] * (len(offsets) - 1)), _varints(offsets[:-1]),
        *(v for v, i in zip(values, indirect) if not i))), path)
    os.makedirs(os.path.dirname(path))
    with open(path, "wb") as f:
        f.writelines(v for v, i in zip(values, indirect) if i)
        f.write(node)
    manifest = b"".join((
        uuid.uuid4().bytes, _varint(0),  # the store's uuid; manifest kind "single"
        _varint(MAX_INLINE_BYTES), _varint(MAX_NODE_BYTES),
        b"\4", _varint(1), struct.pack("<i", 0),  # version tree arity 16; zstd, its default
        _data_file_table([data_path]),
        _varint(1), _varint(1), b"\0",  # one version: generation 1, a root of height 0
        _varint(0), _varint(offsets[-1]), _varint(len(node)),  # the root: file, offset, length
        _varint(len(keys)), _varint(len(node)), _varint(offsets[-1]),
        struct.pack("<Q", time.time_ns()),  # the commit time
        _varint(0)))  # no version tree node outside the manifest
    what = os.path.join(directory, "manifest.ocdbt")
    with open(what, "wb") as f:
        f.write(_encoded_block(MANIFEST_MAGIC, manifest, what))


def _leaves(tree: dict, path=()):
    """(path, value) of every leaf of ``tree`` in JAX's order (dict keys sorted), an
    empty dict among them."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict) and value:
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


def _zarr_entries(name: str, value: np.ndarray, what: str) -> dict[str, bytes]:
    """The ``.zarray`` and the one zstd chunk of ``value`` as orbax writes array
    ``name``."""
    dtype = value.dtype.newbyteorder("<")
    if dtype.str not in ZARR_DTYPES:
        raise JaxCheckpointError(f"{what}: leaf {name!r} of dtype {value.dtype} (the JAX "
                                 f"package writes {ZARR_DTYPES})")
    shape = list(value.shape)
    meta = {"chunks": shape, "compressor": {"id": "zstd", "level": ZARR_ZSTD_LEVEL},
            "dimension_separator": ".", "dtype": dtype.str, "fill_value": None,
            "filters": None, "order": "C", "shape": shape, "zarr_format": 2}
    chunk = f"{name}/" + (".".join("0" * len(shape)) if shape else "0")
    data = np.ascontiguousarray(value, dtype)
    return {f"{name}/.zarray": json.dumps(meta, separators=(",", ":")).encode(),
            chunk: zstd_compress(data, ZARR_ZSTD_LEVEL, f"{what}: {chunk}")}


def write_orbax(directory: str, tree: dict):
    """What ``orbax.checkpoint.StandardCheckpointer().save(directory, tree)`` writes for a
    ``best_*`` tree of the JAX package (``{"params", "batch_stats"}`` nested dicts of
    numpy arrays, ``"epoch"`` an int, ``"test_loss"`` a float), which it restores as
    :func:`read_orbax` reads it (see the module note for the store's layout).
    ``directory`` must not exist, as orbax refuses to overwrite one."""
    started = time.time_ns()
    os.makedirs(directory)
    tree_meta, store, shardings, arrays = {}, {}, {}, []
    for path, value in _leaves(tree):
        name = ".".join(path)
        if isinstance(value, dict):  # an empty dict
            meta = {"value_type": "Dict", "skip_deserialize": True}
        elif isinstance(value, np.ndarray):
            meta = {"value_type": "jax.Array", "skip_deserialize": False,
                    "write_shape": list(value.shape)}
            store.update(_zarr_entries(name, value, directory))
            shardings[base64.b64encode(name.encode()).decode()] = ONE_DEVICE
            arrays.append({"array_metadata": {"param_name": name, "write_shape": list(value.shape),
                                              "chunk_shape": list(value.shape),
                                              "ext_metadata": None}})
        elif isinstance(value, (int, float)) and not isinstance(value, bool):
            meta = {"value_type": "scalar", "skip_deserialize": False}
            dtype = np.int64 if isinstance(value, int) else np.float64
            store.update(_zarr_entries(name, np.asarray(value, dtype), directory))
        else:
            raise JaxCheckpointError(f"{directory}: leaf {name!r} of type "
                                     f"{type(value).__name__}")
        tree_meta[str(path)] = {"key_metadata": [{"key": k, "key_type": 2} for k in path],
                                "value_metadata": meta}
    write_ocdbt(directory, store)
    os.makedirs(os.path.join(directory, "array_metadatas"))
    files = {
        "_METADATA": json.dumps({"tree_metadata": tree_meta, "use_ocdbt": True,
                                 "use_zarr3": False,
                                 "store_array_data_equal_to_fill_value": True,
                                 "custom_metadata": None}),
        "_sharding": json.dumps(shardings, separators=(",", ":")),
        os.path.join("array_metadatas", "process_0"): json.dumps({"array_metadatas": arrays}),
    }
    for name, text in files.items():
        with open(os.path.join(directory, name), "w") as f:
            f.write(text)
    # last, as orbax commits a save with it
    with open(os.path.join(directory, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": ORBAX_HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": started, "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)


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



# msgpack's headers: (the one-byte form's code and the counts it takes, the codes of the
# 8-, 16- and 32-bit forms, None where there is none)
_MAP, _ARRAY = (0x80, 16, (None, 0xDE, 0xDF)), (0x90, 16, (None, 0xDC, 0xDD))
_STR, _BIN = (0xA0, 32, (0xD9, 0xDA, 0xDB)), (0, 0, (0xC4, 0xC5, 0xC6))
_EXT = (0, 0, (0xC7, 0xC8, 0xC9))


def _header(n: int, kind: tuple) -> bytes:
    """msgpack's header of a map, array, string, binary or extension of ``n`` entries or
    bytes: the shortest form that holds ``n``."""
    fix, fix_limit, codes = kind
    if n < fix_limit:
        return bytes([fix | n])
    for limit, fmt, code in zip((0x100, 0x10000, 0x100000000), (">B", ">H", ">I"), codes):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise JaxCheckpointError(f"msgpack: {n} entries or bytes in one value")


# msgpack's integer forms past the fixints, shortest first: unsigned, then signed
_INTS = (((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")),
         ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")))


def _packed_int(n: int) -> bytes:
    """``n`` as msgpack packs a Python int: the shortest form, unsigned where ``n >= 0``."""
    if -32 <= n < 128:
        return struct.pack(">b", n)  # a positive or negative fixint
    for code, fmt in _INTS[n < 0]:
        try:
            return bytes([code]) + struct.pack(fmt, n)
        except struct.error:  # past this form's range
            continue
    raise JaxCheckpointError(f"msgpack: the integer {n} does not fit in 64 bits")


def _packed_array(arr: np.ndarray) -> list:
    """flax's ``_ndarray_to_bytes``: ``(shape, dtype name, C-order bytes)`` packed."""
    data = memoryview(np.ascontiguousarray(arr)).cast("B")
    name = arr.dtype.name.encode()
    return [_header(3, _ARRAY), _header(arr.ndim, _ARRAY),
            *(_packed_int(int(d)) for d in arr.shape), _header(len(name), _STR), name,
            _header(len(data), _BIN), data]


def _packed(value, out: list):
    """``value`` appended to ``out`` as pieces of ``flax.serialization.msgpack_serialize``'s
    output, for what the JAX package's resume state holds: dicts (in their order, string
    keys), numpy arrays as flax's ndarray extension type, and Python ints and floats (as
    doubles)."""
    if isinstance(value, dict):
        out.append(_header(len(value), _MAP))
        for key, v in value.items():
            raw = str(key).encode()
            out.extend((_header(len(raw), _STR), raw))
            _packed(v, out)
    elif isinstance(value, np.ndarray):
        if value.dtype.hasobject or value.dtype.fields is not None or value.nbytes >= 2 ** 30:
            raise JaxCheckpointError(f"msgpack: an array of {value.dtype} and {value.nbytes} "
                                     "bytes (flax chunks one past 1 GiB)")
        payload = _packed_array(value)
        n = sum(len(p) for p in payload)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        out.append(bytes([fixed[n], _FLAX_NDARRAY]) if n in fixed
                   else _header(n, _EXT) + bytes([_FLAX_NDARRAY]))
        out.extend(payload)
    elif isinstance(value, int) and not isinstance(value, bool):
        out.append(_packed_int(value))
    elif isinstance(value, float):
        out.append(b"\xcb" + struct.pack(">d", value))
    else:
        raise JaxCheckpointError(f"msgpack: a value of type {type(value).__name__}")


def write_msgpack(path: str, state: dict):
    """``state`` written to ``path`` as ``flax.serialization.to_bytes(state)`` writes it,
    byte for byte, where ``state`` is the state dict flax makes of its target (dicts in
    their order, so JAX's ``jax.device_get`` trees have their keys sorted): what
    :func:`read_msgpack` reads back."""
    pieces = []
    _packed(state, pieces)
    with open(path, "wb") as f:
        f.writelines(pieces)
