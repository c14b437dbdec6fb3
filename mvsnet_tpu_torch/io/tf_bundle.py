"""Pure-numpy reader/writer for TF1 Saver V2 checkpoints (tensor bundles);
a copy of mvsnet_tpu/io/tf_bundle.py.

The reference ships its trained models as TF Saver checkpoints
(reference: mvsnet/train.py:446 `saver.save(...)`, README.md:43-49), i.e.
a *tensor bundle*: `<prefix>.index` + `<prefix>.data-00000-of-00001`.
This module reads that format with NO tensorflow dependency, so
`tf_import.import_checkpoint` brings the reference's trained weights to
the port wherever numpy runs.

Format (tensorflow/core/util/tensor_bundle/ + leveldb table format):

- `<prefix>.index` is a leveldb-style immutable sorted table:
    file   := block* metaindex_block index_block footer
    block  := entry* restart_offsets(u32 * n) num_restarts(u32)
              + trailer(compression_type u8, masked crc32c u32)
    entry  := varint32 shared_key_len, varint32 unshared_key_len,
              varint32 value_len, key_suffix bytes, value bytes
    footer := BlockHandle(metaindex) BlockHandle(index) padding-to-40B
              magic 0xdb4775248b80fb57 (LE u64)
    BlockHandle := varint64 offset, varint64 size
  Keys are tensor names; values are serialized BundleEntryProto. The
  empty key "" (sorts first) holds the BundleHeaderProto. TF writes the
  index uncompressed (compression type 0).
- `<prefix>.data-NNNNN-of-MMMMM` holds raw little-endian tensor bytes at
  (offset, size) from each BundleEntryProto (shard shard_id).

Proto wire schemas (decoded by hand — protobuf runtime not required):

  BundleHeaderProto { int32 num_shards = 1; Endianness endianness = 2;
                      VersionDef version = 3; }
  BundleEntryProto  { DataType dtype = 1; TensorShapeProto shape = 2;
                      int32 shard_id = 3; int64 offset = 4;
                      int64 size = 5; fixed32 crc32c = 6;
                      repeated TensorSliceProto slices = 7; }
  TensorShapeProto  { repeated Dim dim = 2 { int64 size = 1; }
                      bool unknown_rank = 3; }

The writer emits the same format (single shard, uncompressed, correct
masked CRCs) — it exists so the reader is testable end-to-end without
tensorflow, and as an .npz -> .ckpt escape hatch.

CRC notes: block trailers carry crc32c (Castagnoli) of block+type byte,
masked leveldb-style (rot15 + 0xa282ead8). crc32c is bytewise-sequential,
so verifying multi-MB tensor payloads in pure python is slow; default
verification covers the index blocks only (`verify="index"`), with
"all"/"none" opt-ins. The table lookup runs on Python ints (the JAX
package's copy indexes a numpy table): the same checksums, several times
faster.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, Tuple

import numpy as np

_MAGIC = 0xDB4775248B80FB57
_CRC_MASK_DELTA = 0xA282EAD8

# tensorflow/core/framework/types.proto values we can represent in numpy.
_DTYPES = {
    1: np.dtype("<f4"),   # DT_FLOAT
    2: np.dtype("<f8"),   # DT_DOUBLE
    3: np.dtype("<i4"),   # DT_INT32
    4: np.dtype("<u1"),   # DT_UINT8
    5: np.dtype("<i2"),   # DT_INT16
    6: np.dtype("<i1"),   # DT_INT8
    9: np.dtype("<i8"),   # DT_INT64
    10: np.dtype("?"),    # DT_BOOL
    14: np.dtype("<u2"),  # DT_BFLOAT16 (raw bits; see _BFLOAT16 below)
    17: np.dtype("<u2"),  # DT_UINT16
    19: np.dtype("<f2"),  # DT_HALF
    22: np.dtype("<u4"),  # DT_UINT32
    23: np.dtype("<u8"),  # DT_UINT64
}
_DT_BFLOAT16 = 14
_NP_TO_DT = {
    np.dtype("<f4"): 1, np.dtype("<f8"): 2, np.dtype("<i4"): 3,
    np.dtype("<u1"): 4, np.dtype("<i2"): 5, np.dtype("<i1"): 6,
    np.dtype("<i8"): 9, np.dtype("?"): 10, np.dtype("<u2"): 17,
    np.dtype("<f2"): 19, np.dtype("<u4"): 22, np.dtype("<u8"): 23,
}
try:  # where ml_dtypes is installed, its bfloat16 arrays round-trip as DT_BFLOAT16
    import ml_dtypes as _ml_dtypes

    _NP_TO_DT[np.dtype(_ml_dtypes.bfloat16)] = _DT_BFLOAT16
except ImportError:  # pragma: no cover
    pass


# ---------------------------------------------------------------- crc32c

_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        tbl = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tbl.append(c)
        _CRC_TABLE = tbl
    return _CRC_TABLE


def crc32c(data: bytes, crc: int = 0) -> int:
    tbl = _crc_table()
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _mask_crc(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + _CRC_MASK_DELTA) & 0xFFFFFFFF


def _unmask_crc(masked: int) -> int:
    rot = (masked - _CRC_MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


# ------------------------------------------------------- protobuf wire IO


def _read_varint(buf: bytes, p: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[p]
        p += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, p
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _write_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _iter_proto_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) from a serialized message."""
    p = 0
    while p < len(buf):
        tag, p = _read_varint(buf, p)
        field, wire = tag >> 3, tag & 7
        if wire == 0:                     # varint
            val, p = _read_varint(buf, p)
        elif wire == 1:                   # fixed64
            val = struct.unpack_from("<Q", buf, p)[0]
            p += 8
        elif wire == 2:                   # length-delimited
            n, p = _read_varint(buf, p)
            val = buf[p:p + n]
            p += n
        elif wire == 5:                   # fixed32
            val = struct.unpack_from("<I", buf, p)[0]
            p += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_shape(buf: bytes) -> Tuple[int, ...]:
    dims = []
    for field, _, val in _iter_proto_fields(buf):
        if field == 2:                    # Dim
            size = 0
            for f2, _, v2 in _iter_proto_fields(val):
                if f2 == 1:
                    size = v2
            dims.append(size)
        elif field == 3 and val:
            raise ValueError("unknown-rank tensor in bundle")
    return tuple(dims)


def _parse_entry(buf: bytes) -> dict:
    e = {"dtype": 0, "shape": (), "shard_id": 0, "offset": 0, "size": 0,
         "crc32c": 0, "slices": False}
    for field, _, val in _iter_proto_fields(buf):
        if field == 1:
            e["dtype"] = val
        elif field == 2:
            e["shape"] = _parse_shape(val)
        elif field == 3:
            e["shard_id"] = val
        elif field == 4:
            e["offset"] = val
        elif field == 5:
            e["size"] = val
        elif field == 6:
            e["crc32c"] = val
        elif field == 7:
            e["slices"] = True
    return e


def _parse_header(buf: bytes) -> dict:
    h = {"num_shards": 1, "endianness": 0}
    for field, _, val in _iter_proto_fields(buf):
        if field == 1:
            h["num_shards"] = val
        elif field == 2:
            h["endianness"] = val
    return h


def _tag(field: int, wire: int) -> bytes:
    return _write_varint((field << 3) | wire)


def _emit_entry(dtype: int, shape, shard_id: int, offset: int, size: int,
                crc: int) -> bytes:
    shape_buf = b"".join(
        _tag(2, 2) + _write_varint(len(d)) + d
        for d in (_tag(1, 0) + _write_varint(int(s)) for s in shape))
    out = _tag(1, 0) + _write_varint(dtype)
    out += _tag(2, 2) + _write_varint(len(shape_buf)) + shape_buf
    if shard_id:
        out += _tag(3, 0) + _write_varint(shard_id)
    if offset:
        out += _tag(4, 0) + _write_varint(offset)
    out += _tag(5, 0) + _write_varint(size)
    out += _tag(6, 5) + struct.pack("<I", crc)
    return out


# ----------------------------------------------------------- table reader


def _read_block(buf: bytes, offset: int, size: int, verify: bool) -> bytes:
    data = buf[offset:offset + size]
    if len(data) != size or len(buf) < offset + size + 5:
        raise ValueError("truncated index file")
    ctype = buf[offset + size]
    if verify:
        stored = struct.unpack_from("<I", buf, offset + size + 1)[0]
        actual = crc32c(buf[offset:offset + size + 1])
        if _unmask_crc(stored) != actual:
            raise ValueError(f"index block crc mismatch at {offset}")
    if ctype == 1:
        raise ValueError("snappy-compressed index block — this pure-numpy "
                         "reader handles uncompressed bundles only (TF "
                         "writes bundles uncompressed; this file was "
                         "re-packed). Convert with tensorflow once: "
                         "np.savez(out, **{n: r.get_tensor(n) ...})")
    if ctype != 0:
        raise ValueError(f"unknown block compression type {ctype}")
    return data


def _iter_table_block(data: bytes) -> Iterator[Tuple[bytes, bytes]]:
    (n_restarts,) = struct.unpack_from("<I", data, len(data) - 4)
    end = len(data) - 4 - 4 * n_restarts
    p, key = 0, b""
    while p < end:
        shared, p = _read_varint(data, p)
        unshared, p = _read_varint(data, p)
        vlen, p = _read_varint(data, p)
        key = key[:shared] + data[p:p + unshared]
        p += unshared
        yield key, data[p:p + vlen]
        p += vlen


def read_index(index_path: str, verify: bool = True) -> Tuple[dict, dict]:
    """Parse `<prefix>.index` -> (header dict, {name: entry dict})."""
    with open(index_path, "rb") as f:
        buf = f.read()
    if len(buf) < 48:
        raise ValueError(f"{index_path}: too short for a bundle index")
    footer = buf[-48:]
    (magic,) = struct.unpack_from("<Q", footer, 40)
    if magic != _MAGIC:
        raise ValueError(f"{index_path}: bad table magic {magic:#x} — not "
                         "a TF Saver V2 index file")
    p = 0
    _, p = _read_varint(footer, p)        # metaindex handle (unused)
    _, p = _read_varint(footer, p)
    idx_off, p = _read_varint(footer, p)
    idx_size, p = _read_varint(footer, p)
    index_block = _read_block(buf, idx_off, idx_size, verify)

    header, entries = None, {}
    for _, handle in _iter_table_block(index_block):
        off, q = _read_varint(handle, 0)
        size, _ = _read_varint(handle, q)
        for key, val in _iter_table_block(_read_block(buf, off, size,
                                                      verify)):
            if key == b"":
                header = _parse_header(val)
            else:
                entries[key.decode("utf-8")] = _parse_entry(val)
    if header is None:
        raise ValueError(f"{index_path}: missing bundle header entry")
    return header, entries


def read_bundle(prefix: str, verify: str = "index",
                dtype_policy: str = "numpy") -> Dict[str, np.ndarray]:
    """Read all tensors of a Saver V2 bundle into {name: ndarray}.

    prefix: checkpoint prefix (the path Saver.save returned), i.e.
    `<prefix>.index` and `<prefix>.data-*` exist.
    verify: "index" (default — block CRCs of the small index file),
    "all" (also per-tensor payload CRCs; pure-python crc32c, slow on
    multi-MB tensors), or "none".
    dtype_policy: bfloat16 has no numpy dtype; "numpy" returns those
    tensors as float32 (lossless upcast), "raw" as uint16 bit patterns.
    """
    if verify not in ("index", "all", "none"):
        raise ValueError(f"verify={verify!r}")
    header, entries = read_index(prefix + ".index", verify != "none")
    if header["endianness"] != 0:
        raise ValueError("big-endian bundle not supported")
    num_shards = max(header["num_shards"], 1)

    shards = {}

    def shard(i: int) -> np.memmap:
        if i not in shards:
            path = f"{prefix}.data-{i:05d}-of-{num_shards:05d}"
            shards[i] = np.memmap(path, np.uint8, "r")
        return shards[i]

    out = {}
    for name, e in sorted(entries.items()):
        if e["slices"]:
            raise ValueError(f"{name}: partitioned (sliced) variables not "
                             "supported")
        dt = _DTYPES.get(e["dtype"])
        if dt is None:
            # DT_STRING etc. — not model weights; skip rather than fail
            continue
        raw = bytes(shard(e["shard_id"])[e["offset"]:e["offset"] + e["size"]])
        if len(raw) != e["size"]:
            raise ValueError(f"{name}: truncated data shard")
        if verify == "all" and e["crc32c"]:
            if _unmask_crc(e["crc32c"]) != crc32c(raw):
                raise ValueError(f"{name}: tensor payload crc mismatch")
        arr = np.frombuffer(raw, dt).reshape(e["shape"])
        if e["dtype"] == _DT_BFLOAT16 and dtype_policy == "numpy":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr
    return out


def is_bundle(prefix: str) -> bool:
    """True if `<prefix>.index` exists and carries the table magic."""
    path = prefix + ".index"
    if not os.path.isfile(path):
        return False
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        if f.tell() < 48:
            return False
        f.seek(-8, os.SEEK_END)
        (magic,) = struct.unpack("<Q", f.read(8))
    return magic == _MAGIC


# ----------------------------------------------------------- table writer


def _build_block(records) -> bytes:
    """One table block, restart interval 16 (leveldb default)."""
    out = bytearray()
    restarts = []
    prev = b""
    for i, (key, val) in enumerate(records):
        if i % 16 == 0:
            restarts.append(len(out))
            shared = 0
        else:
            shared = 0
            while (shared < len(prev) and shared < len(key)
                   and prev[shared] == key[shared]):
                shared += 1
        out += _write_varint(shared)
        out += _write_varint(len(key) - shared)
        out += _write_varint(len(val))
        out += key[shared:]
        out += val
        prev = key
    if not restarts:
        restarts = [0]
    for r in restarts:
        out += struct.pack("<I", r)
    out += struct.pack("<I", len(restarts))
    return bytes(out)


def write_bundle(prefix: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write {name: ndarray} as a single-shard TF Saver V2 bundle.

    Produces `<prefix>.index` + `<prefix>.data-00000-of-00001` readable by
    both read_bundle and tf.train.load_checkpoint. Primary use: realistic
    fixtures for the tf_import path (and npz -> ckpt conversion).
    """
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    names = sorted(tensors)
    data = bytearray()
    records = []
    # header at key "" sorts first, as BundleWriter emits it
    header = (_tag(1, 0) + _write_varint(1)          # num_shards = 1
              + _tag(3, 2) + _write_varint(2)        # version {producer: 1}
              + _tag(1, 0) + _write_varint(1))
    records.append((b"", header))
    for name in names:
        # NOT ascontiguousarray: it silently promotes 0-d scalars to 1-d
        arr = np.asarray(tensors[name])
        arr = arr if arr.flags.c_contiguous else arr.copy()
        dt = _NP_TO_DT.get(arr.dtype.newbyteorder("<"))
        if dt is None:
            raise ValueError(f"{name}: dtype {arr.dtype} not supported")
        raw = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        entry = _emit_entry(dt, arr.shape, 0, len(data), len(raw),
                            _mask_crc(crc32c(raw)))
        records.append((name.encode("utf-8"), entry))
        data += raw
    with open(f"{prefix}.data-00000-of-00001", "wb") as f:
        f.write(bytes(data))

    def block_with_trailer(payload: bytes) -> bytes:
        crc = _mask_crc(crc32c(payload + b"\x00"))
        return payload + b"\x00" + struct.pack("<I", crc)

    data_block = _build_block(records)
    out = bytearray()
    data_handle = _write_varint(0) + _write_varint(len(data_block))
    out += block_with_trailer(data_block)
    meta_block = _build_block([])
    meta_off = len(out)
    meta_handle = (_write_varint(meta_off)
                   + _write_varint(len(meta_block)))
    out += block_with_trailer(meta_block)
    # index block: one entry, key >= last data-block key
    last_key = records[-1][0]
    index_block = _build_block([(last_key + b"\xff", data_handle)])
    idx_off = len(out)
    idx_handle = _write_varint(idx_off) + _write_varint(len(index_block))
    out += block_with_trailer(index_block)
    footer = meta_handle + idx_handle
    footer += b"\x00" * (40 - len(footer))
    footer += struct.pack("<Q", _MAGIC)
    out += footer
    with open(f"{prefix}.index", "wb") as f:
        f.write(bytes(out))
