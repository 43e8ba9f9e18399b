"""TF1 ``Saver`` checkpoints → the port's weights, from ``sgg/convert.py``.

:func:`read_tf_checkpoint` reads a TensorFlow V2 checkpoint bundle with numpy
and the standard library alone (TensorFlow is never imported): the
``<prefix>.index`` table (LevelDB's format: a 48-byte footer ending in its
magic, an index block of block handles, data blocks of prefix-compressed keys
with a restart array, and after each block a compression byte and a masked
CRC32C), whose key ``""`` holds the ``BundleHeaderProto`` and every other
key a variable's ``BundleEntryProto``, decoded here by hand as protobuf
varints; then each tensor's bytes from ``<prefix>.data-NNNNN-of-MMMMM``,
checked against the entry's CRC32C as TensorFlow's reader checks them. It
refuses, naming the variable or the file, a compressed block, a big-endian
bundle, a string variable, a partitioned variable and a missing shard.
bfloat16 variables come back as float32 (their 16 bits widened, exactly):
numpy has no bfloat16. :func:`write_tf_checkpoint` writes the same format
(one uncompressed data block, every entry a restart point), which
TensorFlow's reader reads.

The mappings from reference variable names to the flax param paths, and
:func:`convert_from_arrays` and :func:`match_report`, are the reference's
(``sgg/convert.py:39-236``), on nested dicts of numpy arrays: the port's
modules become such trees through ``sgg_torch.convert_flax``
(``generator_state_dict_to_flax``, ``critic_state_dict_to_flax``) and go back
through its ``*_flax_to_state_dict``. ``sgg_torch.cli.convert`` writes a port
workdir from them.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Callable

import numpy as np

# ---------------------------------------------------------------- CRC32C

_POLY = 0x82F63B78  # Castagnoli, reflected
_MASK_DELTA = 0xA282EAD8


def _byte_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(_POLY), t >> 1).astype(np.uint32)
    return t


_TABLE = _byte_table()


def _apply(op: np.ndarray, v):
    """The GF(2)-linear map ``op`` (32 columns: the image of each bit) on the
    uint32 register(s) ``v``."""
    v = np.asarray(v, np.uint32)
    out = np.zeros_like(v)
    for k in range(32):
        out ^= np.where((v >> np.uint32(k)) & np.uint32(1), op[k], np.uint32(0)).astype(np.uint32)
    return out


def _square(op: np.ndarray) -> np.ndarray:
    return _apply(op, op)


_ONE_ZERO_BYTE = np.array([_TABLE[(1 << k) & 0xFF] ^ np.uint32((1 << k) >> 8) for k in range(32)],
                          np.uint32)


_POW2_OPS = [_ONE_ZERO_BYTE]  # the map over 2^k zero bytes, k = 0, 1, ...


def _zeros_op(k: int) -> np.ndarray:
    """The register's map over 2^k zero bytes."""
    while len(_POW2_OPS) <= k:
        _POW2_OPS.append(_square(_POW2_OPS[-1]))
    return _POW2_OPS[k]


def _shift(c: int, n: int) -> int:
    """The register ``c`` after ``n`` zero bytes."""
    v, k = np.uint32(c), 0
    while n:
        if n & 1:
            v = _apply(_zeros_op(k), v)
        n, k = n >> 1, k + 1
    return int(v)


def crc32c(data) -> int:
    """CRC32C (Castagnoli) of ``data`` (bytes-like or a numpy array), in
    numpy: the bytes split into equal lanes, each lane's register run in
    step with the others by the byte table, then the lanes' registers
    combined pairwise by the linear map over a lane's length of zero bytes.
    Zero bytes in front of the data leave a zero register at zero, so the
    data is padded in front to whole lanes."""
    buf = (data.reshape(-1).view(np.uint8) if isinstance(data, np.ndarray)
           else np.frombuffer(memoryview(data).cast("B"), np.uint8))
    n = buf.size
    lane = 1 << max(6, min(9, round(np.log2(max(n, 1)) / 2)))
    lanes = -(-n // lane) or 1
    padded = np.zeros(lanes * lane, np.uint8)
    padded[lanes * lane - n:] = buf
    cols = np.ascontiguousarray(padded.reshape(lanes, lane).T)
    reg = np.zeros(lanes, np.uint32)
    for t in range(lane):
        reg = _TABLE[(reg ^ cols[t]) & np.uint32(0xFF)] ^ (reg >> np.uint32(8))
    seg = lane.bit_length() - 1  # log2 of a segment's bytes
    while reg.size > 1:
        if reg.size % 2:
            reg = np.concatenate([np.zeros(1, np.uint32), reg])
        reg = _apply(_zeros_op(seg), reg[0::2]) ^ reg[1::2]
        seg += 1
    return (_shift(0xFFFFFFFF, n) ^ int(reg[0]) ^ 0xFFFFFFFF) & 0xFFFFFFFF


def mask_crc(crc: int) -> int:
    """TensorFlow's (and LevelDB's) stored form of a CRC32C."""
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + _MASK_DELTA) & 0xFFFFFFFF


def unmask_crc(masked: int) -> int:
    rot = (masked - _MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


# ------------------------------------------------------- protobuf by hand

def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, pos
        shift += 7


def _enc_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _fields(msg: bytes) -> list[tuple[int, int | bytes]]:
    """[(field number, value)] of a serialized message: varints as ints,
    fixed32/fixed64 as ints, length-delimited fields as bytes."""
    out, pos = [], 0
    while pos < len(msg):
        tag, pos = _varint(msg, pos)
        num, wire = tag >> 3, tag & 7
        if wire == 0:
            v, pos = _varint(msg, pos)
        elif wire == 1:
            v, pos = struct.unpack_from("<Q", msg, pos)[0], pos + 8
        elif wire == 2:
            n, pos = _varint(msg, pos)
            v, pos = bytes(msg[pos:pos + n]), pos + n
        elif wire == 5:
            v, pos = struct.unpack_from("<I", msg, pos)[0], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        out.append((num, v))
    return out


def _field(num: int, v) -> bytes:
    if isinstance(v, bytes):
        return _enc_varint(num << 3 | 2) + _enc_varint(len(v)) + v
    return _enc_varint(num << 3) + _enc_varint(v)


# TensorFlow's DataType enum → numpy (bfloat16, 14, is read as float32).
_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16, 6: np.int8,
           9: np.int64, 10: np.bool_, 17: np.uint16, 19: np.float16, 22: np.uint32,
           23: np.uint64}
_BFLOAT16, _STRING = 14, 7
_DT_OF = {np.dtype(v): k for k, v in _DTYPES.items()}


def _entry(msg: bytes) -> dict:
    e = {"dtype": 0, "shape": [], "shard_id": 0, "offset": 0, "size": 0, "crc32c": None,
         "slices": 0}
    for num, v in _fields(msg):
        if num == 1:
            e["dtype"] = v
        elif num == 2:
            for dnum, dim in _fields(v):
                if dnum == 2:
                    e["shape"].append(dict(_fields(dim)).get(1, 0))
        elif num == 3:
            e["shard_id"] = v
        elif num == 4:
            e["offset"] = v
        elif num == 5:
            e["size"] = v
        elif num == 6:
            e["crc32c"] = v
        elif num == 7:
            e["slices"] += 1
    return e


# ------------------------------------------------------------- the table

_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER = 48


def _block(buf: bytes, handle: tuple[int, int], what: str) -> bytes:
    off, size = handle
    if off + size + 5 > len(buf):
        raise ValueError(f"{what}: block at {off} runs past the end of the file")
    ctype = buf[off + size]
    (stored,) = struct.unpack_from("<I", buf, off + size + 1)
    if unmask_crc(stored) != crc32c(buf[off:off + size + 1]):
        raise ValueError(f"{what}: block at {off}: checksum mismatch")
    if ctype != 0:
        raise ValueError(f"{what}: block at {off} is compressed (type {ctype}); only "
                         "uncompressed tables are read")
    return buf[off:off + size]


def _block_entries(block: bytes):
    """(key, value) of each entry of a block: keys share a prefix with the
    previous key; the restart array at the end marks where sharing starts
    over."""
    (n_restarts,) = struct.unpack_from("<I", block, len(block) - 4)
    limit = len(block) - 4 - 4 * n_restarts
    restarts = set(struct.unpack_from(f"<{n_restarts}I", block, limit))
    if limit < 0 or any(r > max(limit, 0) for r in restarts):
        raise ValueError("corrupt block: bad restart array")
    pos, key = 0, b""
    while pos < limit:
        shared, pos = _varint(block, pos)
        if pos in restarts and shared:
            raise ValueError("corrupt block: a restart point shares a prefix")
        non_shared, pos = _varint(block, pos)
        vlen, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        yield key, block[pos:pos + vlen]
        pos += vlen


def _handle(buf: bytes, pos: int) -> tuple[tuple[int, int], int]:
    off, pos = _varint(buf, pos)
    size, pos = _varint(buf, pos)
    return (off, size), pos


def _table_items(path: str) -> list[tuple[bytes, bytes]]:
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < _FOOTER or struct.unpack_from("<Q", buf, len(buf) - 8)[0] != _TABLE_MAGIC:
        raise ValueError(f"{path}: not a TensorFlow table (bad footer magic)")
    footer = buf[len(buf) - _FOOTER:]
    _, pos = _handle(footer, 0)  # the metaindex, which holds nothing a bundle needs
    index, _ = _handle(footer, pos)
    items = []
    for _, value in _block_entries(_block(buf, index, path)):
        handle, _ = _handle(value, 0)
        items.extend(_block_entries(_block(buf, handle, path)))
    return items


def _prefix(path: str) -> str:
    """The bundle prefix of ``path``: the path itself, or for a directory the
    prefix its ``checkpoint`` file names (``model_checkpoint_path``)."""
    if not os.path.isdir(path):
        return path
    state = os.path.join(path, "checkpoint")
    if not os.path.exists(state):
        raise FileNotFoundError(f"{path} is a directory without a 'checkpoint' file")
    with open(state) as f:
        m = re.search(r'^model_checkpoint_path:\s*"(.*)"\s*$', f.read(), re.M)
    if m is None:
        raise ValueError(f"{state} names no model_checkpoint_path")
    prefix = m.group(1).encode().decode("unicode_escape")
    return prefix if os.path.isabs(prefix) else os.path.join(path, prefix)


def read_tf_checkpoint(path: str) -> dict[str, np.ndarray]:
    """Read a TF1 name-based (V2 bundle) checkpoint into {var_name: ndarray}:
    ``path`` is its prefix, or a directory whose ``checkpoint`` file names
    one (both as ``tf.train.load_checkpoint`` takes them)."""
    prefix = _prefix(path)
    index = prefix + ".index"
    if not os.path.exists(index):
        raise FileNotFoundError(f"{index} not found: not a V2 checkpoint bundle")
    header, entries, slice_keys = None, {}, []
    for key, value in _table_items(index):
        if key == b"":
            header = dict(_fields(value))
        elif key.startswith(b"\x00"):
            slice_keys.append(key)  # a partitioned variable's slice
        else:
            entries[key.decode()] = _entry(value)
    if header is None:
        raise ValueError(f"{index}: no bundle header")
    if header.get(2, 0) != 0:
        raise ValueError(f"{index}: a big-endian bundle; only little-endian bundles are read")
    num_shards = header.get(1, 1)
    out, files = {}, {}
    try:
        for name, e in entries.items():
            if e["slices"]:
                raise ValueError(f"variable {name!r} is partitioned ({e['slices']} slices); "
                                 "partitioned variables are not read")
            if e["dtype"] == _STRING:
                raise ValueError(f"variable {name!r} is a string tensor; only numeric "
                                 "variables are read")
            if e["dtype"] != _BFLOAT16 and e["dtype"] not in _DTYPES:
                raise ValueError(f"variable {name!r} has an unsupported dtype (DataType "
                                 f"{e['dtype']})")
            dt = np.dtype(np.uint16 if e["dtype"] == _BFLOAT16 else _DTYPES[e["dtype"]])
            count = int(np.prod(e["shape"], dtype=np.int64))
            if e["size"] != count * dt.itemsize:
                raise ValueError(f"variable {name!r}: {e['size']} bytes for shape "
                                 f"{e['shape']} of {dt}")
            shard = f"{prefix}.data-{e['shard_id']:05d}-of-{num_shards:05d}"
            if shard not in files:
                if not os.path.exists(shard):
                    raise FileNotFoundError(f"variable {name!r}: shard {shard} is missing")
                files[shard] = open(shard, "rb")
            f = files[shard]
            f.seek(e["offset"])
            raw = f.read(e["size"])
            if len(raw) != e["size"]:
                raise ValueError(f"variable {name!r}: {shard} ends before its bytes")
            if e["crc32c"] is not None and unmask_crc(e["crc32c"]) != crc32c(raw):
                raise ValueError(f"variable {name!r}: checksum mismatch in {shard}")
            a = np.frombuffer(raw, dt.newbyteorder("<")).astype(dt).reshape(e["shape"])
            if e["dtype"] == _BFLOAT16:
                a = (a.astype(np.uint32) << 16).view(np.float32)
            out[name] = a
    finally:
        for f in files.values():
            f.close()
    if slice_keys and not any(e["slices"] for e in entries.values()):
        raise ValueError(f"{index}: holds slices of a partitioned variable; partitioned "
                         "variables are not read")
    return out


def write_tf_checkpoint(prefix: str, arrays: dict[str, np.ndarray]) -> None:
    """Write ``arrays`` as a one-shard V2 checkpoint bundle at ``prefix``
    (``.index`` and ``.data-00000-of-00001``), the format
    :func:`read_tf_checkpoint` and TensorFlow's reader read."""
    data, items = bytearray(), []
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        if a.dtype not in _DT_OF:
            raise ValueError(f"variable {name!r}: dtype {a.dtype} has no DataType here")
        raw = a.astype(a.dtype.newbyteorder("<")).tobytes()
        shape = b"".join(_field(2, _field(1, int(d))) for d in a.shape)
        msg = (_field(1, _DT_OF[a.dtype]) + _field(2, shape)
               + (_field(4, len(data)) if data else b"") + (_field(5, len(raw)) if raw else b"")
               + _enc_varint(6 << 3 | 5) + struct.pack("<I", mask_crc(crc32c(raw))))
        items.append((name.encode(), msg))
        data += raw
    header = _field(1, 1) + _field(3, _field(1, 1))  # num_shards 1, version {producer 1}
    items.insert(0, (b"", header))

    def block(entries) -> bytes:
        out, restarts = bytearray(), []
        for k, v in entries:
            restarts.append(len(out))
            out += _enc_varint(0) + _enc_varint(len(k)) + _enc_varint(len(v)) + k + v
        restarts = restarts or [0]
        return bytes(out) + struct.pack(f"<{len(restarts)}I", *restarts) + struct.pack(
            "<I", len(restarts))

    table = bytearray()

    def put(contents: bytes) -> bytes:
        off = len(table)
        table.extend(contents + b"\x00")
        table.extend(struct.pack("<I", mask_crc(crc32c(contents + b"\x00"))))
        return _enc_varint(off) + _enc_varint(len(contents))

    data_h = put(block(items))
    meta_h = put(block([]))
    index_h = put(block([(items[-1][0], data_h)]))
    table += (meta_h + index_h).ljust(40, b"\x00") + struct.pack("<Q", _TABLE_MAGIC)
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    with open(f"{prefix}.data-00000-of-00001", "wb") as f:
        f.write(data)
    with open(f"{prefix}.index", "wb") as f:
        f.write(table)


# ------------------------------------------------- names → param paths

# Each entry: param path (tuple) → (reference var regex, transform), the
# reference's (``sgg/convert.py:39-120``). Transforms run on the raw array.
_ID = lambda a: a  # noqa: E731

DEFAULT_GENERATOR_MAPPING: dict[tuple[str, ...], tuple[str, Callable]] = {
    ("token_embedding",): (r"(generator/)?embedding(/weights|/w)?$", _ID),
    ("init_c", "kernel"): (r"(generator/)?init_c/(weights|kernel|w)$", _ID),
    ("init_c", "bias"): (r"(generator/)?init_c/(biases|bias|b)$", _ID),
    ("init_h", "kernel"): (r"(generator/)?init_h/(weights|kernel|w)$", _ID),
    ("init_h", "bias"): (r"(generator/)?init_h/(biases|bias|b)$", _ID),
    ("TF1LSTMCell_0", "kernel"): (
        r"(generator/)?(rnn/)?(basic_)?lstm_cell/(kernel|weights)$", _ID,
    ),
    ("TF1LSTMCell_0", "bias"): (
        r"(generator/)?(rnn/)?(basic_)?lstm_cell/(bias|biases)$", _ID,
    ),
    ("AdditiveAttention_0", "feat_proj", "kernel"): (
        r"(generator/)?att(ention)?/feat(ure)?_proj/(weights|kernel)$", _ID,
    ),
    ("AdditiveAttention_0", "state_proj", "kernel"): (
        r"(generator/)?att(ention)?/(state|h)_proj/(weights|kernel)$", _ID,
    ),
    ("AdditiveAttention_0", "state_proj", "bias"): (
        r"(generator/)?att(ention)?/(state|h)_proj/(biases|bias)$", _ID,
    ),
    ("AdditiveAttention_0", "score", "kernel"): (
        r"(generator/)?att(ention)?/(score|v)/(weights|kernel)$", _ID,
    ),
    ("deep_out", "kernel"): (r"(generator/)?deep_out(put)?/(weights|kernel)$", _ID),
    ("deep_out", "bias"): (r"(generator/)?deep_out(put)?/(biases|bias)$", _ID),
    ("vocab_proj", "kernel"): (r"(generator/)?(logits|vocab_proj|decode)/(weights|kernel)$", _ID),
    ("vocab_proj", "bias"): (r"(generator/)?(logits|vocab_proj|decode)/(biases|bias)$", _ID),
}

DEFAULT_DISCRIMINATOR_MAPPING: dict[tuple[str, ...], tuple[str, Callable]] = {
    ("token_embedding",): (r"(discriminator|critic)/embedding(/weights|/w)?$", _ID),
    ("query_proj", "kernel"): (
        r"(discriminator|critic)/(query|q)_proj/(weights|kernel)$", _ID,
    ),
    ("query_proj", "bias"): (
        r"(discriminator|critic)/(query|q)_proj/(biases|bias)$", _ID,
    ),
    ("key_proj", "kernel"): (
        r"(discriminator|critic)/(key|k)_proj/(weights|kernel)$", _ID,
    ),
    ("score", "kernel"): (
        r"(discriminator|critic)/(score|v)/(weights|kernel)$", _ID,
    ),
    ("trunk_0", "kernel"): (
        r"(discriminator|critic)/(trunk|fc|dense)_?0/(weights|kernel)$", _ID,
    ),
    ("trunk_0", "bias"): (
        r"(discriminator|critic)/(trunk|fc|dense)_?0/(biases|bias)$", _ID,
    ),
    ("trunk_1", "kernel"): (
        r"(discriminator|critic)/(trunk|fc|dense)_?1/(weights|kernel)$", _ID,
    ),
    ("trunk_1", "bias"): (
        r"(discriminator|critic)/(trunk|fc|dense)_?1/(biases|bias)$", _ID,
    ),
    ("trunk_2", "kernel"): (
        r"(discriminator|critic)/(trunk|fc|dense)_?2/(weights|kernel)$", _ID,
    ),
    ("trunk_2", "bias"): (
        r"(discriminator|critic)/(trunk|fc|dense)_?2/(biases|bias)$", _ID,
    ),
    ("ln_0", "scale"): (r"(discriminator|critic)/ln_?0(/LayerNorm)?/(gamma|scale)$", _ID),
    ("ln_0", "bias"): (r"(discriminator|critic)/ln_?0(/LayerNorm)?/(beta|bias)$", _ID),
    ("ln_1", "scale"): (r"(discriminator|critic)/ln_?1(/LayerNorm)?/(gamma|scale)$", _ID),
    ("ln_1", "bias"): (r"(discriminator|critic)/ln_?1(/LayerNorm)?/(beta|bias)$", _ID),
    ("ln_2", "scale"): (r"(discriminator|critic)/ln_?2(/LayerNorm)?/(gamma|scale)$", _ID),
    ("ln_2", "bias"): (r"(discriminator|critic)/ln_?2(/LayerNorm)?/(beta|bias)$", _ID),
    ("head", "kernel"): (
        r"(discriminator|critic)/(head|out(put)?)/(weights|kernel)$", _ID,
    ),
    ("head", "bias"): (
        r"(discriminator|critic)/(head|out(put)?)/(biases|bias)$", _ID,
    ),
}

# One Saver checkpoint holds the generator's and the critic's variables in
# one namespace; the generator patterns' optional prefix would otherwise also
# match e.g. "discriminator/embedding".
GENERATOR_EXCLUDE = r"discriminator|critic|vgg"
DISCRIMINATOR_EXCLUDE = r"generator|vgg"


def _copy_tree(tree: dict) -> dict:
    return {k: _copy_tree(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def convert_from_arrays(
    tf_vars: dict[str, np.ndarray],
    target_params: dict,
    mapping: dict[tuple[str, ...], tuple[str, Callable]] | None = None,
    strict: bool = True,
    exclude: str | None = None,
) -> tuple[dict, list[str]]:
    """Place reference arrays into a copy of ``target_params``, a nested
    dict of arrays in flax's layout whose shapes the arrays must match.
    ``exclude``: a regex of reference names to ignore (it scopes the search
    when one checkpoint holds several nets). A path the tree lacks is
    skipped. Raises on an ambiguous match, a shape mismatch, and with
    ``strict`` on unmatched paths. Returns (params as float32 numpy,
    unmatched paths)."""
    mapping = mapping or DEFAULT_GENERATOR_MAPPING
    if exclude is not None:
        ex = re.compile(exclude)
        tf_vars = {n: v for n, v in tf_vars.items() if not ex.search(n)}
    params = _copy_tree(target_params)
    unmatched = []
    for path, (pattern, transform) in mapping.items():
        rx = re.compile(pattern)
        hits = [n for n in tf_vars if rx.search(n)]
        node = params
        try:
            for p in path[:-1]:
                node = node[p]
            tgt = node[path[-1]]
        except KeyError:
            continue  # a param this architecture lacks
        if not hits:
            unmatched.append("/".join(path))
            continue
        if len(hits) > 1:
            raise ValueError(f"ambiguous match for {path}: {hits}")
        arr = np.asarray(transform(tf_vars[hits[0]]), dtype=np.float32)
        if arr.shape != tuple(tgt.shape):
            raise ValueError(f"shape mismatch for {'/'.join(path)}: reference {arr.shape} "
                             f"vs target {tuple(tgt.shape)}")
        node[path[-1]] = arr
    if strict and unmatched:
        raise ValueError(f"unmatched reference variables for params: {unmatched}; "
                         "pass a custom mapping or strict=False")
    return params, unmatched


def match_report(tf_vars: dict[str, np.ndarray],
                 targets: dict[str, tuple[dict, dict, str | None]]) -> dict:
    """Which reference variable feeds which param, without placing any:
    ``targets`` is {net: (param tree, mapping, exclude regex)}. Returns
    {"matched": [(net/path, name, shape)], "unmatched_params": [...],
    "ambiguous": [(net/path, names)], "unused_vars": [...]}."""
    used: set[str] = set()
    matched, unmatched, ambiguous = [], [], []
    for net, (_tree, mapping, exclude) in targets.items():
        ex = re.compile(exclude) if exclude else None
        names = [n for n in tf_vars if ex is None or not ex.search(n)]
        for path, (pattern, _tf) in mapping.items():
            rx = re.compile(pattern)
            hits = [n for n in names if rx.search(n)]
            label = f"{net}/{'/'.join(path)}"
            if len(hits) == 1:
                matched.append((label, hits[0], tuple(np.shape(tf_vars[hits[0]]))))
                used.add(hits[0])
            elif not hits:
                unmatched.append(label)
            else:
                ambiguous.append((label, hits))
    return {"matched": matched, "unmatched_params": unmatched, "ambiguous": ambiguous,
            "unused_vars": sorted(set(tf_vars) - used)}
