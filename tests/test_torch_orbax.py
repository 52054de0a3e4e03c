"""The port's orbax twin (``utils/orbax_io.py``, ``_ocdbt.py``, ``_zstd.py``)
against orbax, tensorstore and zstandard on the CPU.

* The zstd decoder against ``zstandard``: generated bytes (random,
  repetitive, float32 weights) at levels 1, 3, 9 and 19 with and without
  checksum and content size; cases that reach each corner of the format
  (checked by watching the decoder's lines run); hand-made frames that
  ``zstandard`` decodes as well; and every frame in the committed fixture.
* The OCDBT reader against ``tensorstore.KvStore`` listings: the fixture, a
  JAX-written checkpoint of 3,000 arrays and tensorstore stores whose small
  node limit forces interior B+tree nodes.
* JAX -> port and port -> JAX through the two ``load_checkpoint_orbax``:
  params, EMA, ``n_averaged``, float64 betas, step and metadata bit for bit;
  a small UNet1D's forward after the round trip at the forward tests'
  tolerance; and the refusals.

All inputs are made from seeds; every comparison is bit-equal unless said
otherwise. Tests that need orbax, tensorstore or zstandard skip without them,
as ``tests/test_checkpoint.py::test_orbax_roundtrip`` does.
"""

import inspect
import io
import json
import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hypothesis import given, settings, strategies as st

from diffsg_tpu.diffusion import cosine_schedule as jax_cosine_schedule
from diffsg_tpu.train import ema_init as jax_ema_init, ema_update as jax_ema_update
from diffsg_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from diffsg_tpu_torch.models import UNet1D, unet_apply_fn
from diffsg_tpu_torch.train import EmaState
from diffsg_tpu_torch.diffusion import cosine_schedule, schedule_from_betas
from diffsg_tpu_torch.utils import load_checkpoint, params_from_jax, params_to_jax
from diffsg_tpu_torch.utils import _ocdbt, _zstd, orbax_io
from diffsg_tpu_torch.utils._ocdbt import OcdbtError, read_ocdbt
from diffsg_tpu_torch.utils._zstd import ZstdError, compress_raw, decompress, xxh64
from diffsg_tpu_torch.utils.orbax_io import (OrbaxFormatError, load_checkpoint_orbax,
                                             save_checkpoint_orbax)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "orbax_ddpm_nu_3u_aug32_s8c"
NPZ = REPO / "ckpts" / "ddpm_nu_3u_aug32_s8c"
LEVELS = (1, 3, 9, 19)


def _need(module):
    return pytest.importorskip(module, reason=f"{module} is not installed")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_tree_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# --- zstd ------------------------------------------------------------------

def _zstd_ref(frame: bytes) -> bytes:
    """``zstandard``'s decode of one frame, strict about trailing bytes."""
    zstandard = _need("zstandard")
    return zstandard.ZstdDecompressor().decompress(frame, max_output_size=1 << 26,
                                                   allow_extra_data=False)


def _compress(data, level, checksum=False, content_size=True):
    zstandard = _need("zstandard")
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=content_size).compress(data)


def _float_weights(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * rng.uniform(0.01, 1.0)).astype(np.float32).tobytes()


_payloads = st.one_of(
    st.binary(max_size=3000),
    st.builds(lambda parts, reps: b"".join(parts) * reps,
              st.lists(st.binary(min_size=1, max_size=12), min_size=1, max_size=30),
              st.integers(1, 60)),
    st.builds(_float_weights, st.integers(0, 1500), st.integers(0, 2 ** 32 - 1)),
)


@settings(max_examples=80, deadline=None, derandomize=True, database=None)
@given(data=_payloads, level=st.sampled_from(LEVELS), checksum=st.booleans(),
       content_size=st.booleans())
def test_zstd_decodes_what_zstandard_writes(data, level, checksum, content_size):
    frame = _compress(data, level, checksum, content_size)
    assert decompress(frame) == data == _zstd_ref(frame)


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(data=_payloads, level=st.sampled_from(LEVELS), where=st.floats(0, 1),
       bit=st.integers(0, 7), cut=st.booleans())
def test_zstd_corrupt_frames_raise(data, level, where, bit, cut):
    """A checksummed frame with a bit flipped, or cut short, raises
    :class:`ZstdError` (and no other error), or decodes to exactly its
    content (a flip in a bit the format ignores): never to anything else."""
    frame = bytearray(_compress(data, level, checksum=True))
    i = min(int(where * len(frame)), len(frame) - 1)
    if cut:
        frame = frame[:i]
    else:
        frame[i] ^= 1 << bit
    try:
        got = decompress(bytes(frame))
    except ZstdError:
        return
    assert got == data


def _gen(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "shift":  # slowly drifting bytes: repeat offsets, rep0 - 1
        return bytes((np.arange(n) // 7 + rng.integers(0, 2, n)).astype(np.uint8))
    if kind == "periodic":  # a period with sparse errors: long overlapping matches
        return bytes(((np.arange(n) % 13) * (rng.random(n) > 0.05)).astype(np.uint8))
    if kind == "const":
        return b"\x07" * n
    if kind == "text":
        return bytes(rng.choice(np.frombuffer(b"etaoinshrdlu ", np.uint8), n))
    if kind == "floats":
        return _float_weights(n // 4 + 1, seed)[:n]
    raise ValueError(kind)


def _decode_watched(frame, monkeypatch):
    """Decode ``frame`` and return what the decoder ran: the source lines of
    ``_block``, ``_literals`` and ``_sequence_tables`` that executed, the
    Huffman weight kinds and the FSE distributions read from the frame."""
    seen = {"lines": set(), "weights": set(), "norms": []}
    watched = {_zstd._block.__code__, _zstd._literals.__code__,
               _zstd._sequence_tables.__code__}
    src = {}
    for fn in (_zstd._block, _zstd._literals, _zstd._sequence_tables):
        lines, first = inspect.getsourcelines(fn)
        src.update({first + i: ln.strip() for i, ln in enumerate(lines)})

    def tracer(frame, event, arg):
        if frame.f_code in watched:
            def local(fr, ev, a):
                if ev == "line":
                    seen["lines"].add(src.get(fr.f_lineno, ""))
                return local
            return local
        return None

    read_huff, fse_table = _zstd._read_huffman_description, _zstd._fse_table

    def huff(data, start):
        seen["weights"].add("direct" if data[start] >= 128 else "fse")
        return read_huff(data, start)

    def table(norm, log):
        if norm not in (_zstd._LL_DEFAULT, _zstd._ML_DEFAULT, _zstd._OF_DEFAULT):
            seen["norms"].append(list(norm))
        return fse_table(norm, log)

    monkeypatch.setattr(_zstd, "_read_huffman_description", huff)
    monkeypatch.setattr(_zstd, "_fse_table", table)
    sys.settrace(tracer)
    try:
        out = decompress(frame)
    finally:
        sys.settrace(None)
    return out, seen


# (generator, size, level): each case reaches the corner it is named for
CORNERS = {
    "repeat offset rep0 - 1 after a zero literal length":
        (("shift", 20000, 19), "rep0, rep1, rep2 = rep0 - 1, rep0, rep1"),
    "match overlapping its own output":
        (("periodic", 5000, 3), "period = out[start:]"),
    "four Huffman streams and their jump table":
        (("text", 5000, 3), "sizes = [int.from_bytes(block[start + 2 * i:start + 2 * i + 2], "
                            "\"little\") for i in range(3)]"),
    "treeless literals":
        (("periodic", 400000, 19), "elif state.huffman is None:"),
    "repeat-mode tables carried between blocks":
        (("periodic", 400000, 19), "elif state.tables[k] is None:"),
    "RLE literals":
        (("periodic", 400000, 19), "return bytes([block[head]]) * regen, head + 1"),
    "RLE sequence table":
        (("shift", 400000, 22), "state.tables[k] = _rle_table(block[p])"),
    "single-stream Huffman literals":
        (("text", 200, 3), "_huffman_stream(table, block[start:end], regen, out)"),
}


@pytest.mark.parametrize("corner", sorted(CORNERS))
def test_zstd_corner_against_zstandard(corner, monkeypatch):
    (kind, n, level), line = CORNERS[corner]
    data = _gen(kind, n)
    frame = _compress(data, level)
    out, seen = _decode_watched(frame, monkeypatch)
    assert out == data == _zstd_ref(frame)
    assert line in seen["lines"], f"{corner}: the case no longer reaches it"


def test_zstd_huffman_weights_both_kinds_and_fse_below_one(monkeypatch):
    """Huffman weights FSE-coded (text) and direct (few symbols); FSE
    distributions with "less than 1" probabilities (-1)."""
    seen_weights, norms = set(), []
    for kind, n in (("text", 20000), ("periodic", 400000)):
        frame = _compress(_gen(kind, n), 19)
        out, seen = _decode_watched(frame, monkeypatch)
        assert out == _zstd_ref(frame)
        seen_weights |= seen["weights"]
        norms += seen["norms"]
    assert seen_weights == {"direct", "fse"}
    assert any(-1 in norm for norm in norms)


def test_zstd_rle_block_and_multi_block_frames():
    for data in (_gen("const", 300000), _gen("floats", 300000), _gen("text", 300000)):
        for level in LEVELS:
            frame = _compress(data, level, checksum=True)
            assert decompress(frame) == data == _zstd_ref(frame)


def test_zstd_huffman_table_of_the_rfc_example():
    """RFC 8878 4.2.1.3: weights 4, 3, 2, 0, 1 and the implied last weight 1
    give symbol 0 the code 1, 1 -> 01, 2 -> 001, 4 -> 0000, 5 -> 0001."""
    table = _zstd._huffman_from_weights([4, 3, 2, 0, 1])
    assert table.max_bits == 4
    codes = {}
    for index, e in enumerate(table.entries):
        sym, nb = e & 255, e >> 8
        codes.setdefault(sym, format(index, "04b")[:nb])
    assert codes == {0: "1", 1: "01", 2: "001", 4: "0000", 5: "0001"}


def _frame_header(fcs_bytes: int, size: int, single: bool, dict_id: bytes = b"") -> bytes:
    flag = {0: 0, 1: 0, 2: 1, 4: 2, 8: 3}[fcs_bytes]
    fhd = (flag << 6) | (int(single) << 5) | {0: 0, 1: 1, 2: 2, 4: 3}[len(dict_id)]
    window = b"" if single else bytes([(17 - 10) << 3])  # 128 KiB
    value = size - 256 if fcs_bytes == 2 else size
    fcs = value.to_bytes(fcs_bytes, "little") if fcs_bytes else b""
    return _zstd.MAGIC.to_bytes(4, "little") + bytes([fhd]) + window + dict_id + fcs


def _raw_blocks(data: bytes) -> bytes:
    return compress_raw(data)[6 if len(data) < 256 else 7 if len(data) < 65792 else 9:]


@pytest.mark.parametrize("fcs_bytes,single,size", [
    (1, True, 200), (2, True, 300), (2, False, 60000), (4, True, 100000),
    (8, True, 5000), (8, False, 200000), (0, False, 1000), (4, False, 0)])
def test_zstd_frame_header_variants(fcs_bytes, single, size):
    """Every content-size width, with and without the single-segment flag
    (and then the window descriptor); ``zstandard`` decodes each too."""
    data = _gen("floats", size)
    frame = _frame_header(fcs_bytes, size, single) + _raw_blocks(data)
    assert decompress(frame) == data == _zstd_ref(frame)


def test_zstd_dictionary_id_skippable_and_concatenated_frames():
    zstandard = _need("zstandard")
    data = _gen("text", 3000)
    body = _raw_blocks(data)
    for did in (b"\x00", b"\x00\x00", b"\x00" * 4):  # a present but zero dictionary id
        frame = _frame_header(2, len(data), True, did) + body
        assert decompress(frame) == data == _zstd_ref(frame)
    with pytest.raises(ZstdError, match="dictionary"):
        decompress(_frame_header(2, len(data), True, b"\x07") + body)
    skip = (0x184D2A5E).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    a, b = _compress(data, 3), _compress(data[::-1], 9, checksum=True, content_size=False)
    stream = skip + a + skip + b
    want = zstandard.ZstdDecompressor().stream_reader(io.BytesIO(stream),
                                                      read_across_frames=True).read()
    assert decompress(stream) == want == data + data[::-1]


def test_zstd_sequence_count_in_three_bytes():
    """A block of 32,600 sequences (count >= 0x7F00, its three-byte form):
    raw literals of length 0, RLE tables (literal length 0, offset code 0,
    match length 3), so every sequence reads no bits and takes repeat offset
    1 then 4 alternately. ``zstandard`` decodes it too."""
    nseq = 32600
    seed = b"abcdefgh"
    block = (bytes([0x00])  # raw literals, size 0
             + bytes([0xFF]) + (nseq - 0x7F00).to_bytes(2, "little")
             + bytes([0x54, 0, 0, 0])  # RLE for all three, symbols 0
             + bytes([0x01]))  # a bit stream of no bits
    size = len(seed) + 3 * nseq
    frame = (_frame_header(4, size, True)
             + ((len(seed) << 3) | 0).to_bytes(3, "little") + seed
             + ((len(block) << 3) | (2 << 1) | 1).to_bytes(3, "little") + block)
    got = decompress(frame)
    assert len(got) == size and got == _zstd_ref(frame)


def test_zstd_refusals():
    frame = bytearray(_compress(_gen("text", 2000), 3, checksum=True))
    frame[-1] ^= 0x10
    with pytest.raises(ZstdError, match="checksum"):
        decompress(bytes(frame))
    with pytest.raises(ZstdError, match="magic"):
        decompress(b"\x00" * 16)
    with pytest.raises(ZstdError):
        decompress(b"")
    with pytest.raises(ZstdError, match="reserved block type"):
        decompress(_frame_header(1, 3, True) + ((3 << 3) | (3 << 1) | 1).to_bytes(3, "little"))


@pytest.mark.parametrize("size", [0, 1, 255, 256, 65791, 65792, 131072, 300001])
def test_compress_raw_frames_read_by_zstandard(size):
    data = _gen("floats", size)
    frame = compress_raw(data)
    assert _zstd_ref(frame) == data == decompress(frame)
    assert len(frame) - len(data) <= 13 + 3 * (size // _zstd.BLOCK_MAX)


def test_xxh64_vectors():
    # the published values of XXH64 with seed 0
    assert xxh64(b"") == 0xEF46DB3751D8E999
    assert xxh64(b"abc") == 0x44BC2CF5AD770999
    # every stripe and tail length, through frames zstandard checksummed
    for n in range(0, 70):
        data = bytes(range(n))
        assert decompress(_compress(data, 1, checksum=True)) == data


# --- the fixture -----------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_store():
    return read_ocdbt(FIXTURE)


def test_fixture_is_orbax_ocdbt_with_jax_arrays():
    meta = json.loads((FIXTURE / "_METADATA").read_text())
    assert meta["use_ocdbt"] is True and meta["use_zarr3"] is False
    kinds = {v["value_metadata"]["value_type"] for v in meta["tree_metadata"].values()}
    assert kinds == {"np.ndarray", "jax.Array"}
    assert (FIXTURE / "_sharding").is_file() and (FIXTURE / "array_metadatas").is_dir()
    assert (FIXTURE / "ocdbt.process_0" / "manifest.ocdbt").is_file()


def test_fixture_frames_against_zstandard(fixture_store, monkeypatch):
    """Every zstd frame of the fixture: the chunks, and the manifests and
    B+tree nodes of the merged store and of the per-process one."""
    frames = [v for k, v in fixture_store.items() if not k.endswith(b"/.zarray")]
    framing = []

    def recording(data):
        framing.append(data)
        return decompress(data)

    monkeypatch.setattr(_ocdbt, "decompress", recording)
    read_ocdbt(FIXTURE)
    read_ocdbt(FIXTURE / "ocdbt.process_0")
    assert len(framing) >= 4  # two manifests and their nodes
    for frame in frames + framing:
        assert frame[:4] == b"\x28\xb5\x2f\xfd"
        assert decompress(frame) == _zstd_ref(frame)


def test_fixture_equals_the_npz_through_jax():
    """JAX's own reader of the fixture against the npz checkpoint it was
    written from, so the fixture cannot drift."""
    _need("orbax.checkpoint")
    from diffsg_tpu.utils.orbax_io import load_checkpoint_orbax as jax_load
    got, want = jax_load(str(FIXTURE)), jax_load_checkpoint(str(NPZ))
    _assert_tree_equal(got["params"], want["params"])
    _assert_tree_equal(got["ema"].params, want["ema"].params)
    assert int(got["ema"].n_averaged) == int(want["ema"].n_averaged)
    np.testing.assert_array_equal(np.asarray(got["sched"].betas), np.asarray(want["sched"].betas))
    assert got["step"] == want["step"] and got["metadata"] == want["metadata"]


def test_fixture_through_the_port_equals_the_npz():
    got = load_checkpoint_orbax(str(FIXTURE), device="cpu")
    want = load_checkpoint(str(NPZ), device="cpu", training=True)
    _assert_tree_equal(got["params"], want["params"])
    _assert_state_equal(got["ema"].params, want["ema"].params)
    assert got["ema"].n_averaged == want["ema"].n_averaged
    for name in want["sched"]._fields:
        assert torch.equal(getattr(got["sched"], name), getattr(want["sched"], name)), name
    assert got["step"] == want["step"] == 200
    assert got["metadata"] == want["metadata"] and got["metadata"]["augmented_times"] == 32
    # the float64 betas as stored, against the npz's
    get = orbax_io._store(FIXTURE, True)
    betas = orbax_io._read_array(get, "schedule_betas")
    with np.load(NPZ / "arrays.npz") as z:
        np.testing.assert_array_equal(betas, z["schedule/betas"])
        assert betas.dtype == z["schedule/betas"].dtype == np.float64


# --- OCDBT -----------------------------------------------------------------

def _ts_items(directory):
    ts = _need("tensorstore")
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{pathlib.Path(directory).absolute()}/"}).result()
    keys = kv.list().result()
    reads = [kv.read(k) for k in keys]  # all in flight at once
    return {k: r.result().value for k, r in zip(keys, reads)}


def test_ocdbt_fixture_against_tensorstore(fixture_store):
    assert fixture_store == _ts_items(FIXTURE)
    assert len(fixture_store) == 2 * 799
    # the per-process store that orbax merged into the root reads alone
    assert read_ocdbt(FIXTURE / "ocdbt.process_0") == fixture_store


def test_ocdbt_jax_checkpoint_of_3000_arrays(tmp_path):
    """JAX's ``save_checkpoint_orbax`` of 3,000 small arrays (orbax keeps
    them in one B+tree leaf of 6,002 keys)."""
    _need("orbax.checkpoint")
    from diffsg_tpu.utils.orbax_io import save_checkpoint_orbax as jax_save
    rng = np.random.default_rng(0)
    params = {f"layer_{i:04d}": {"kernel": rng.standard_normal((3, 2)).astype(np.float32),
                                 "bias": rng.standard_normal(2).astype(np.float32)}
              for i in range(1500)}
    jax_save(str(tmp_path / "ck"), params, step=3)
    items = read_ocdbt(tmp_path / "ck")
    assert len(items) == 2 * 3001 and items == _ts_items(tmp_path / "ck")
    got = load_checkpoint_orbax(str(tmp_path / "ck"), device="cpu")
    _assert_tree_equal(got["params"], params)
    assert got["step"] == 3 and got["metadata"] == {} and "ema" not in got


@pytest.mark.parametrize("node_bytes,commits,compression", [
    (2048, 3, None), (600, 20, {"id": "zstd", "level": 7}), (4096, 1, {"id": "zstd"})])
def test_ocdbt_interior_nodes_against_tensorstore(tmp_path, node_bytes, commits, compression):
    """Stores that tensorstore writes with a small node limit: B+trees of
    height 2 or more (interior nodes, common key prefixes), inline and
    indirect values, and more commits than the manifest keeps inline."""
    ts = _need("tensorstore")
    config = {"max_decoded_node_bytes": node_bytes, "max_inline_value_bytes": 64}
    if compression:
        config["compression"] = compression
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": config}).result()
    rng = np.random.default_rng(node_bytes)
    for c in range(commits):
        with ts.Transaction() as txn:
            for i in range(3600 // commits):
                key = f"group_{c % 3}/key_{int(rng.integers(0, 5000)):05d}/v"
                kv.with_transaction(txn)[key] = rng.bytes(int(rng.integers(1, 200)))
    want = _ts_items(tmp_path)
    assert read_ocdbt(tmp_path) == want and len(want) > 1000
    assert _ocdbt.OcdbtStore(tmp_path)._root()[4] >= 2  # interior nodes below the root


def _copy_fixture(tmp_path):
    dst = tmp_path / "ck"
    shutil.copytree(FIXTURE, dst)
    return dst


def test_ocdbt_corrupt_node_crc_raises(tmp_path):
    ck = _copy_fixture(tmp_path)
    node = next((ck / "d").iterdir())
    raw = bytearray(node.read_bytes())
    raw[100] ^= 1
    node.write_bytes(bytes(raw))
    with pytest.raises(OcdbtError, match="CRC-32C"):
        load_checkpoint_orbax(str(ck), device="cpu")
    manifest = ck / "manifest.ocdbt"
    raw = bytearray(manifest.read_bytes())
    raw[-1] ^= 1
    manifest.write_bytes(bytes(raw))
    with pytest.raises(OcdbtError, match="manifest.ocdbt: CRC-32C"):
        read_ocdbt(ck)


def test_crc32c_vector():
    assert _ocdbt.crc32c(b"123456789") == 0xE3069283  # the Castagnoli check value


# --- JAX -> port -----------------------------------------------------------

def _jax_roundtrip_tree():
    """``test_orbax_roundtrip``'s tree, from ``jnp`` arrays."""
    params = {"dense": {"kernel": jnp.arange(6.0).reshape(2, 3), "bias": jnp.ones(3)}}
    ema = jax_ema_update(jax_ema_init(params), params, 0.999)
    return params, ema, jax_cosine_schedule(20)


def test_jax_written_checkpoint_reads_in_the_port(tmp_path):
    _need("orbax.checkpoint")
    from diffsg_tpu.utils.orbax_io import save_checkpoint_orbax as jax_save
    params, ema, sched = _jax_roundtrip_tree()
    jax_save(str(tmp_path / "ock"), params, ema=ema, step=7, sched=sched,
             metadata={"task": "msr", "dims": [4, 2]})
    assert json.loads((tmp_path / "ock" / "_METADATA").read_text())["use_ocdbt"] is True
    ck = load_checkpoint_orbax(str(tmp_path / "ock"), device="cpu")
    _assert_tree_equal(ck["params"], jax.tree.map(np.asarray, params))
    _assert_state_equal(ck["ema"].params, params_from_jax(jax.tree.map(np.asarray, ema.params)))
    assert ck["ema"].n_averaged == int(ema.n_averaged) == 1
    assert ck["step"] == 7 and ck["metadata"] == {"task": "msr", "dims": [4, 2]}
    want = schedule_from_betas(np.asarray(sched.betas, np.float64), device="cpu")
    for name in want._fields:
        assert torch.equal(getattr(ck["sched"], name), getattr(want, name)), name
    betas = orbax_io._read_array(orbax_io._store(tmp_path / "ock", True), "schedule_betas")
    assert betas.dtype == np.float64
    np.testing.assert_array_equal(betas, np.asarray(sched.betas, np.float64))


# --- port -> JAX -----------------------------------------------------------

def _port_tree(seed):
    rng = np.random.default_rng(seed)
    params = {"dense": {"kernel": rng.standard_normal((2, 3)).astype(np.float32),
                        "bias": rng.standard_normal(3).astype(np.float32)},
              "scale": np.asarray(rng.standard_normal(), np.float32)}  # a 0-d leaf
    ema = EmaState({k: v * 0.5 for k, v in params_from_jax(params).items()}, 3)
    return params, ema, cosine_schedule(20, device="cpu")


def test_port_written_checkpoint_reads_in_jax(tmp_path):
    _need("orbax.checkpoint")
    from diffsg_tpu.utils.orbax_io import load_checkpoint_orbax as jax_load
    zstandard = _need("zstandard")
    out = tmp_path / "pck"
    params, ema, sched = _port_tree(0)
    assert save_checkpoint_orbax(str(out), params, ema=ema, step=11, sched=sched) == str(out)
    assert not (out / "diffsg_metadata.json").exists()  # no metadata, no sidecar
    meta = json.loads((out / "_METADATA").read_text())
    assert meta["use_ocdbt"] is False and meta["use_zarr3"] is False
    assert {v["value_metadata"]["value_type"] for v in meta["tree_metadata"].values()} == \
        {"np.ndarray"}
    assert meta["tree_metadata"]["('params', 'scale')"]["key_metadata"] == [
        {"key": "params", "key_type": 2}, {"key": "scale", "key_type": 2}]
    spec = json.loads((out / "params.dense.kernel" / ".zarray").read_text())
    assert spec["compressor"] == {"id": "zstd", "level": 1} and spec["chunks"] == [2, 3]
    chunk = (out / "params.dense.kernel" / "0.0").read_bytes()
    assert zstandard.ZstdDecompressor().decompress(chunk) == params["dense"]["kernel"].tobytes()
    assert (out / "params.scale" / "0").is_file()

    ck = jax_load(str(out))
    _assert_tree_equal(ck["params"], params)
    _assert_tree_equal(ck["ema"].params, {"dense": {k: v * 0.5 for k, v in params["dense"].items()},
                                          "scale": params["scale"] * 0.5})
    assert int(np.asarray(ck["ema"].n_averaged)) == 3
    assert ck["step"] == 11 and ck["metadata"] == {}
    np.testing.assert_array_equal(np.asarray(ck["sched"].betas), sched.betas.numpy())
    # and the port reads its own writing
    mine = load_checkpoint_orbax(str(out), device="cpu")
    _assert_tree_equal(mine["params"], params)
    _assert_state_equal(mine["ema"].params, ema.params)


def test_port_save_overwrites_an_existing_checkpoint(tmp_path):
    _need("orbax.checkpoint")
    from diffsg_tpu.utils.orbax_io import load_checkpoint_orbax as jax_load
    out = tmp_path / "pck"
    first, _, _ = _port_tree(1)
    first["extra"] = {"w": np.ones((4, 4), np.float32)}
    save_checkpoint_orbax(str(out), first, step=1, metadata={"run": 1})
    second, ema, sched = _port_tree(2)
    save_checkpoint_orbax(str(out), second, ema=ema, step=2, sched=sched,
                          metadata={"run": 2})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["pck"]  # no temporary left
    assert not (out / "params.extra.w").exists()
    for ck in (jax_load(str(out)), load_checkpoint_orbax(str(out), device="cpu")):
        _assert_tree_equal(ck["params"], second)
        assert ck["step"] == 2 and ck["metadata"] == {"run": 2}


def test_port_roundtrip_of_the_msr_checkpoint(tmp_path):
    """The MSR-3c T=100 net (params, EMA, step, betas, metadata) through
    the port's writer and reader, and JAX's reader."""
    _need("orbax.checkpoint")
    from diffsg_tpu.utils.orbax_io import load_checkpoint_orbax as jax_load
    src = load_checkpoint(str(REPO / "ckpts" / "ddpm_msr_3c_T100"), device="cpu", training=True)
    save_checkpoint_orbax(str(tmp_path / "m"), src["params"], ema=src["ema"], step=src["step"],
                          sched=src["sched"], metadata=src["metadata"])
    got = load_checkpoint_orbax(str(tmp_path / "m"), device="cpu")
    _assert_tree_equal(got["params"], src["params"])
    _assert_state_equal(got["ema"].params, src["ema"].params)
    assert (got["step"], got["metadata"], got["ema"].n_averaged) == \
        (src["step"], src["metadata"], src["ema"].n_averaged)
    for name in src["sched"]._fields:
        assert torch.equal(getattr(got["sched"], name), getattr(src["sched"], name)), name
    jck = jax_load(str(tmp_path / "m"))
    _assert_tree_equal(jck["params"], src["params"])
    assert jck["metadata"] == src["metadata"]


# --- the slice as a whole --------------------------------------------------

def test_small_unet_forward_after_jax_orbax_roundtrip(tmp_path):
    """A small UNet1D (two widths, one block each) with numpy-seeded weights,
    written by JAX's ``save_checkpoint_orbax`` from ``jnp`` arrays and read
    by the port's reader: the plain forward on the CPU against JAX's forward
    of the same checkpoint read by JAX's reader."""
    _need("orbax.checkpoint")
    from diffsg_tpu.models.unet1d import UNet1D as JaxUNet1D
    from diffsg_tpu.utils.orbax_io import (load_checkpoint_orbax as jax_load,
                                           save_checkpoint_orbax as jax_save)
    arch = dict(input_dim=3, proj_dim=16, cond_dim=3, dims=(8, 4), n_blocks=1)
    model = UNet1D(**arch)
    rng = np.random.default_rng(5)
    params = jax.tree.map(lambda a: jnp.asarray((0.3 * rng.standard_normal(a.shape)).astype(
        np.float32)), params_to_jax(model))
    rows = 16
    inputs = (rng.normal(size=(rows, 3)).astype(np.float32), np.array([0.37], np.float32),
              rng.uniform(size=(rows, 3)).astype(np.float32),
              np.concatenate([np.zeros((rows // 2, 1)), np.ones((rows // 2, 1))]).astype(
                  np.float32))
    jax_save(str(tmp_path / "net"), params, step=5, sched=jax_cosine_schedule(10),
             metadata={"arch": arch})
    jmodel = JaxUNet1D(**arch, is_attn=(False, False))
    want = np.asarray(jmodel.apply({"params": jax_load(str(tmp_path / "net"))["params"]},
                                   *inputs))
    ck = load_checkpoint_orbax(str(tmp_path / "net"), device="cpu")
    model.load_state_dict(params_from_jax(ck["params"]), strict=True)
    with torch.no_grad():
        got = unet_apply_fn(model, "plain")(*[torch.from_numpy(a) for a in inputs]).numpy()
    # the tolerance of tests/test_torch_unet.py's forward of a random net
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert ck["step"] == 5 and ck["metadata"]["arch"]["dims"] == [8, 4]


# --- refusals --------------------------------------------------------------

def _edit_json(path, fn):
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data))


def test_refuses_zarr3(tmp_path):
    out = tmp_path / "c"
    save_checkpoint_orbax(str(out), _port_tree(0)[0])
    _edit_json(out / "_METADATA", lambda m: m.update(use_zarr3=True))
    with pytest.raises(OrbaxFormatError, match="use_zarr3"):
        load_checkpoint_orbax(str(out), device="cpu")


@pytest.mark.parametrize("field,value,match", [
    ("compressor", {"id": "blosc", "cname": "lz4"}, "compressor blosc"),
    ("filters", [{"id": "delta", "dtype": "<f4"}], "filters"),
    ("order", "F", "order F"),
    ("dtype", "<c8", "dtype"),
])
def test_refuses_zarr_fields(tmp_path, field, value, match):
    out = tmp_path / "c"
    save_checkpoint_orbax(str(out), _port_tree(0)[0])
    _edit_json(out / "params.dense.kernel" / ".zarray", lambda s: s.update({field: value}))
    with pytest.raises(OrbaxFormatError, match=match):
        load_checkpoint_orbax(str(out), device="cpu")


def test_no_fallback_to_the_npz_reader():
    with pytest.raises(FileNotFoundError):
        load_checkpoint_orbax(str(NPZ), device="cpu")


def test_zarr_chunk_grids_separators_and_fill(tmp_path):
    """Arrays that tensorstore's zarr driver writes in several chunks (edge
    chunks included), with ``/`` as the separator, and with chunks never
    written (they read as the fill value)."""
    ts = _need("tensorstore")
    rng = np.random.default_rng(3)
    full = rng.standard_normal((7, 10)).astype(np.float32)
    cases = {"grid": ".", "slash": "/"}
    for name, sep in cases.items():
        t = ts.open({"driver": "zarr", "kvstore": f"file://{tmp_path}/{name}",
                     "metadata": {"shape": [7, 10], "chunks": [3, 4], "dtype": "<f4",
                                  "dimension_separator": sep,
                                  "compressor": {"id": "zstd", "level": 5}}},
                    create=True).result()
        t.write(full).result()
    t = ts.open({"driver": "zarr", "kvstore": f"file://{tmp_path}/partial",
                 "metadata": {"shape": [7, 10], "chunks": [3, 4], "dtype": "<i4",
                              "fill_value": -5, "compressor": None}},
                create=True).result()
    t[3:6, 4:8].write(np.arange(12, dtype=np.int32).reshape(3, 4)).result()
    get = orbax_io._store(tmp_path, False)
    for name in cases:
        np.testing.assert_array_equal(orbax_io._read_array(get, name), full)
    want = np.full((7, 10), -5, np.int32)
    want[3:6, 4:8] = np.arange(12).reshape(3, 4)
    got = orbax_io._read_array(get, "partial")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
