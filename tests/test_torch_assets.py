"""The port's asset readers against the JAX package on the CPU: the
payload reader and writer, the `.g*` container, the KvList codecs and
`decode_gsnd`. Files written by either side are byte-equal and each side
reads the other's; the container's error cases raise the same class."""

from __future__ import annotations

import numpy as np
import pytest

from c_game_engine_tpu.assets import container as j_container
from c_game_engine_tpu.assets import kvlist as j_kv
from c_game_engine_tpu.assets import reader as j_reader
from c_game_engine_tpu.assets.codecs import decode_gsnd as j_decode_gsnd
from c_game_engine_tpu_torch.assets import container, kvlist as kv, reader
from c_game_engine_tpu_torch.assets.codecs import decode_gsnd
from c_game_engine_tpu_torch.audio.bank import BUILTIN_SOUNDS
from c_game_engine_tpu_torch.audio.synthetic_sounds import write_synthetic_sounds


def _payload(w, rng):
    """Write one of each field through writer `w` from seeded values; returns
    the values in order."""
    vals = [int(rng.integers(0, 256)), int(rng.integers(0, 2**16)), int(rng.integers(0, 2**32)),
            int(rng.integers(-2**31, 2**31)), int(rng.integers(0, 2**63)), float(np.float32(rng.normal())),
            float(rng.normal()), bytes(rng.integers(0, 256, 7).astype(np.uint8)), "grüßeé map"]
    w.u8(vals[0]).u16(vals[1]).u32(vals[2]).i32(vals[3]).u64(vals[4]).f32(vals[5]).f64(vals[6])
    w.raw(vals[7]).string(vals[8])
    return vals


def _read(r):
    return [r.u8(), r.u16(), r.u32(), r.i32(), r.u64(), r.f32(), r.f64(), r.raw(7), r.string()]


def test_reader_writer_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        seed = int(rng.integers(0, 2**31))
        vals = _payload(reader.Writer(), np.random.default_rng(seed))
        mine = reader.Writer()
        _payload(mine, np.random.default_rng(seed))
        theirs = j_reader.Writer()
        _payload(theirs, np.random.default_rng(seed))
        assert mine.getvalue() == theirs.getvalue()
        assert _read(j_reader.Reader(mine.getvalue())) == vals
        r = reader.Reader(theirs.getvalue())
        assert _read(r) == vals and r.remaining() == 0
    r = reader.Reader(b"\x01\x02")
    with pytest.raises(reader.PayloadError):
        r.u32()
    with pytest.raises(reader.PayloadError):
        r.skip(3)


def test_container_round_trips_both_ways(tmp_path):
    rng = np.random.default_rng(1)
    data = rng.integers(0, 4, 5000).astype(np.uint8).tobytes()
    for i, atype in enumerate(container.AssetType):
        mine, theirs = tmp_path / f"p{i}.gkvl", tmp_path / f"j{i}.gkvl"
        container.write_asset(mine, container.Asset(atype, 3, data))
        j_container.write_asset(theirs, j_container.Asset(j_container.AssetType(int(atype)), 3, data))
        assert mine.read_bytes() == theirs.read_bytes()
        a, b = j_container.read_asset(mine), container.read_asset(theirs)
        assert (int(a.type), a.type_version, a.data) == (int(atype), 3, data)
        assert (b.type, b.type_version, b.data) == (atype, 3, data)


@pytest.mark.parametrize("case", ["short", "magic", "version", "truncated", "corrupt", "dsize"])
def test_container_errors_raise_the_same_class(tmp_path, case):
    good = tmp_path / "good.gtex"
    container.write_asset(good, container.Asset(container.AssetType.TEXTURE, 1, b"pixels" * 40))
    raw = bytearray(good.read_bytes())
    hdr = container.HEADER
    magic, version, atype, tv, dsize, csize = hdr.unpack_from(raw, 0)
    if case == "short":
        raw = raw[:10]
    elif case == "magic":
        hdr.pack_into(raw, 0, 0x12345678, version, atype, tv, dsize, csize)
    elif case == "version":
        hdr.pack_into(raw, 0, magic, 3, atype, tv, dsize, csize)
    elif case == "truncated":
        raw = raw[:-5]
    elif case == "corrupt":
        raw[hdr.size + 12] ^= 0xFF
        raw[hdr.size + 13] ^= 0xFF
    else:
        hdr.pack_into(raw, 0, magic, version, atype, tv, dsize + 1, csize)
    bad = tmp_path / "bad.gtex"
    bad.write_bytes(bytes(raw))
    with pytest.raises(container.AssetFormatError) as mine:
        container.read_asset(bad)
    with pytest.raises(j_container.AssetFormatError) as theirs:
        j_container.read_asset(bad)
    assert str(mine.value) == str(theirs.value)


def _kv_json():
    """A mapSources-style JSON kvlist with every parameter type, nested."""
    return {
        "b": {"type": "byte", "value": 200}, "i": {"type": "int", "value": -17},
        "f": {"type": "float", "value": 0.1}, "t": {"type": "bool", "value": True},
        "s": {"type": "string", "value": "door1"}, "n": {"type": "none"},
        "c": {"type": "color", "value": {"r": 1.0, "g": 0.5, "b": 0.25, "a": 1.0}},
        "u": {"type": "u64", "value": 2**40 + 3}, "v2": {"type": "vec2", "value": {"x": 1.5, "y": -2.0}},
        "v3": {"type": "vec3", "value": {"x": 0.0, "y": 1.0, "z": -3.25}},
        "arr": {"type": "array", "value": [{"type": "int", "value": k} for k in range(3)]
                + [{"type": "kvlist", "value": {"deep": {"type": "string", "value": "x"}}}]},
        "kv": {"type": "kvlist", "value": {"inner": {"type": "float", "value": 2.5},
                                           "flag": {"type": "bool", "value": False}}},
    }


def test_kvlist_codecs_match_jax():
    mine, theirs = kv.kvlist_from_json(_kv_json()), j_kv.kvlist_from_json(_kv_json())
    assert [(k, int(p.type)) for k, p in mine.items()] == [(k, int(p.type)) for k, p in theirs.items()]
    w, jw = reader.Writer(), j_reader.Writer()
    kv.write_kvlist(w, mine)
    j_kv.write_kvlist(jw, theirs)
    assert w.getvalue() == jw.getvalue()
    back = kv.read_kvlist(reader.Reader(jw.getvalue()))
    jback = j_kv.read_kvlist(j_reader.Reader(w.getvalue()))
    # f32 fields come back rounded; both sides read the same values
    assert repr(back) == repr(jback)
    w2 = reader.Writer()
    kv.write_kvlist(w2, back)
    assert w2.getvalue() == w.getvalue()
    assert kv.get_vec3(back, "v3") == (0.0, 1.0, -3.25) and kv.get_byte(back, "b") == 200
    assert kv.get_int(back, "f", 9) == 9 and kv.get_color(back, "missing") == (1.0, 1.0, 1.0, 1.0)
    assert kv.get_string(back["kv"].value, "inner", "d") == "d" and kv.get_float(back["kv"].value, "inner") == 2.5
    assert back["arr"].value[3].value["deep"] == kv.Param(kv.ParamType.STRING, "x")
    assert kv.Param.none() == kv.read_param(reader.Reader(b"\x05"))


@pytest.fixture(scope="module")
def sounds(tmp_path_factory):
    return write_synthetic_sounds(tmp_path_factory.mktemp("sounds"), seed=3)


@pytest.mark.parametrize("name", BUILTIN_SOUNDS)
def test_decode_gsnd_matches_jax(sounds, name):
    mine, theirs = decode_gsnd(sounds / name), j_decode_gsnd(sounds / name)
    assert mine.rate == theirs.rate and mine.pcm.dtype == np.float32 and mine.pcm.shape[1] == 2
    np.testing.assert_array_equal(mine.pcm, theirs.pcm)


def test_synthetic_sounds_cover_every_decode_branch(sounds):
    import io
    import wave

    formats = []
    for name in BUILTIN_SOUNDS:
        w = wave.open(io.BytesIO(container.read_asset(sounds / name).data))
        formats.append((w.getframerate(), w.getsampwidth(), w.getnchannels()))
    assert formats == [(22050, 2, 1), (44100, 2, 2), (48000, 1, 1), (32000, 2, 3)]
    not_sound = sounds / "x.gtex"
    container.write_asset(not_sound, container.Asset(container.AssetType.TEXTURE, 1, b"\x00"))
    with pytest.raises(reader.PayloadError):
        decode_gsnd(not_sound)


def _gtex_bytes(rng, w, h, fmt, flags):
    """A .gtex payload (TextureLoader.c:70-140) of seeded pixels."""
    wr = reader.Writer().u64(w).u64(h)
    for f in flags:
        wr.u8(f)
    wr.u8(fmt)
    if fmt == 0:
        wr.raw(rng.integers(0, 256, (h, w, 4)).astype(np.uint8).tobytes())
    else:
        wr.raw(rng.uniform(-2.0, 8.0, (h, w, 4)).astype(np.float16).tobytes())
    return wr.getvalue()


@pytest.mark.parametrize("fmt, flags", [(0, (1, 0, 1)), (0, (0, 1, 0)), (1, (1, 1, 1))])
def test_decode_gtex_matches_jax(tmp_path, fmt, flags):
    """RGBA8 and RGBA16F textures written by the port's container writer,
    with each filter / repeat / mipmaps flag: the same Texture, pixels
    bit for bit."""
    from c_game_engine_tpu.assets.codecs import decode_gtex as j_decode_gtex
    from c_game_engine_tpu_torch.assets.codecs import decode_gtex

    path = tmp_path / "t.gtex"
    rng = np.random.default_rng(fmt * 10 + sum(flags))
    container.write_asset(path, container.Asset(container.AssetType.TEXTURE, 1, _gtex_bytes(rng, 7, 5, fmt, flags)))
    mine, theirs = decode_gtex(path), j_decode_gtex(path)
    assert (mine.width, mine.height, mine.filter, mine.repeat, mine.mipmaps) == \
        (theirs.width, theirs.height, theirs.filter, theirs.repeat, theirs.mipmaps) == (7, 5, *map(bool, flags))
    assert mine.pixels.dtype == np.float32 and mine.pixels.shape == (5, 7, 4)
    np.testing.assert_array_equal(mine.pixels, theirs.pixels)


@pytest.mark.parametrize("texture_width", [None, 256])
def test_decode_gfon_matches_jax(tmp_path, texture_width):
    """A font written by the port's container writer (FontLoader.c:79-110:
    eight u8 metrics, the texture name, the glyph table): the same Font,
    UV tables bit for bit, with and without the end-UV inset."""
    from c_game_engine_tpu.assets.codecs import decode_gfon as j_decode_gfon
    from c_game_engine_tpu_torch.assets.codecs import decode_gfon

    rng = np.random.default_rng(4)
    chars = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 .:%"
    wr = reader.Writer()
    for v in (12, 16, 13, 1, 2, 5, 16, 1):
        wr.u8(v)
    wr.string("interface/small_font").u8(len(chars))
    for ch in chars:
        wr.u8(ord(ch)).u8(int(rng.integers(3, 12)))
    path = tmp_path / "f.gfon"
    container.write_asset(path, container.Asset(container.AssetType.FONT, 1, wr.getvalue()))
    mine, theirs = decode_gfon(path, texture_width), j_decode_gfon(path, texture_width)
    for f in ("texture", "width", "texture_height", "baseline", "char_spacing", "line_spacing", "space_width",
              "default_size", "uppercase_only", "chars"):
        assert getattr(mine, f) == getattr(theirs, f), f
    assert mine.texture == "texture/interface/small_font.gtex" and mine.uppercase_only and mine.chars == chars
    for f in ("widths", "start_uvs", "end_uvs"):
        a, b = getattr(mine, f), getattr(theirs, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_checkerboard_and_wrong_types(tmp_path):
    from c_game_engine_tpu.assets.codecs import checkerboard_fallback as j_checker
    from c_game_engine_tpu_torch.assets.codecs import checkerboard_fallback, decode_gfon, decode_gtex

    for size in (64, 8):
        mine, theirs = checkerboard_fallback(size), j_checker(size)
        assert (mine.width, mine.height, mine.filter, mine.repeat, mine.mipmaps) == \
            (theirs.width, theirs.height, theirs.filter, theirs.repeat, theirs.mipmaps)
        np.testing.assert_array_equal(mine.pixels, theirs.pixels)
    wav = tmp_path / "s.gsnd"
    container.write_asset(wav, container.Asset(container.AssetType.WAV, 1, b"RIFF"))
    for decode in (decode_gtex, decode_gfon):
        with pytest.raises(reader.PayloadError):
            decode(wav)
