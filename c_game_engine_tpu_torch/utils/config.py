"""Run configuration (counterpart of c_game_engine_tpu/utils/config.py):
the reference's config tiers as game.gkvl -> GameConfig, options.kvl ->
Options and CLI flags -> RunConfig.

Options mirrors the reference's Options.c:32-175 field for field and
round-trips through the binary .kvl codec; a saved file is byte-equal to
the JAX package's."""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field
from pathlib import Path

from c_game_engine_tpu_torch.assets import kvlist as kv
from c_game_engine_tpu_torch.assets.container import Asset, AssetType, read_asset, write_asset
from c_game_engine_tpu_torch.assets.reader import Reader, Writer

# (field, kvlist key, ParamType) in the file's key order
_OPTIONS = (
    ("rpc", "rpc", kv.ParamType.BOOL),
    ("camera_speed", "cameraSpeed", kv.ParamType.FLOAT),
    ("rumble", "rumble", kv.ParamType.BOOL),
    ("invert_horizontal_camera", "invertHorizontalCamera", kv.ParamType.BOOL),
    ("invert_vertical_camera", "invertVerticalCamera", kv.ParamType.BOOL),
    ("swap_ok_cancel", "swapOkCancel", kv.ParamType.BOOL),
    ("fullscreen", "fullscreen", kv.ParamType.BOOL),
    ("vsync", "vsync", kv.ParamType.BOOL),
    ("msaa", "msaa", kv.ParamType.INTEGER),
    ("mipmaps", "mipmaps", kv.ParamType.BOOL),
    ("prefer_wayland", "preferWayland", kv.ParamType.BOOL),
    ("limit_fps_when_unfocused", "limitFpsWhenUnfocused", kv.ParamType.BOOL),
    ("lod_multiplier", "lodMultiplier", kv.ParamType.FLOAT),
    ("fov", "fov", kv.ParamType.FLOAT),
    ("anisotropy", "anisotropy", kv.ParamType.INTEGER),
    ("max_fps", "maxFps", kv.ParamType.INTEGER),
    ("master_volume", "masterVolume", kv.ParamType.FLOAT),
    ("music_volume", "musicVolume", kv.ParamType.FLOAT),
    ("sfx_volume", "sfxVolume", kv.ParamType.FLOAT),
    ("ui_volume", "uiVolume", kv.ParamType.FLOAT),
)


@dataclass
class Options:
    # defaults per Options.c:20-45 (DefaultOptions)
    rpc: bool = True
    camera_speed: float = 1.0
    rumble: bool = True
    invert_horizontal_camera: bool = False
    invert_vertical_camera: bool = False
    swap_ok_cancel: bool = False
    fullscreen: bool = False
    vsync: bool = True
    msaa: int = 0
    mipmaps: bool = True
    prefer_wayland: bool = False
    limit_fps_when_unfocused: bool = True
    lod_multiplier: float = 1.0
    fov: float = 90.0
    anisotropy: int = 0
    max_fps: int = 0
    master_volume: float = 1.0
    music_volume: float = 1.0
    sfx_volume: float = 1.0
    ui_volume: float = 1.0

    def validate(self):
        # Options.c:55-100 bounds
        self.fov = min(max(self.fov, 30.0), 120.0)
        self.msaa = min(max(self.msaa, 0), 8)
        self.lod_multiplier = min(max(self.lod_multiplier, 0.25), 4.0)
        return self

    def to_kvlist(self):
        return {key: kv.Param(t, getattr(self, name)) for name, key, t in _OPTIONS}

    @staticmethod
    def from_kvlist(m) -> "Options":
        """Options from a kvlist; a missing key or one of another type takes
        its default."""
        default = Options()
        return Options(**{name: kv._get(m, key, t, getattr(default, name)) for name, key, t in _OPTIONS}).validate()

    def save(self, path: str):
        w = Writer()
        kv.write_kvlist(w, self.to_kvlist())
        write_asset(path, Asset(AssetType.KV_LIST, 1, w.getvalue()))

    @staticmethod
    def load(path: str) -> "Options":
        """The options saved at `path`; defaults where there is no file."""
        if not Path(path).exists():
            return Options()
        a = read_asset(path)
        return Options.from_kvlist(kv.read_kvlist(Reader(a.data)))


@dataclass
class GameConfig:
    """game.gkvl (GameConfigLoader.c:102-145)."""

    title: str = "GAME"
    copyright: str = ""
    discord_app_id: int = 0
    background_map: str = ""
    search_paths: list = field(default_factory=list)  # [(path, allow_code_execution, path_type)]

    @staticmethod
    def load(path: str) -> "GameConfig":
        a = read_asset(path)
        m = kv.read_kvlist(Reader(a.data))
        paths = []
        for p in kv._get(m, "search_paths", kv.ParamType.ARRAY, []):
            sub = p.value
            paths.append(
                (
                    kv.get_string(sub, "search_path", ""),
                    kv.get_bool(sub, "allow_code_execution", False),
                    kv.get_string(sub, "path_type", ""),
                )
            )
        return GameConfig(
            title=kv.get_string(m, "game_title", "GAME"),
            copyright=kv.get_string(m, "game_copyright", ""),
            discord_app_id=kv._get(m, "discord_app_id", kv.ParamType.UINT_64, 0),
            background_map=kv.get_string(m, "background_map", ""),
            search_paths=paths,
        )


@dataclass
class RunConfig:
    """CLI for batched runs (the Arguments.h:10-45 flags that still apply
    headless). `map` is a committed map's name or a `.gmap` or editor-JSON
    source path (models/sim.py::make_sim compiles a source). It defaults to
    the committed map `arena`: the JAX package's default is the reference's
    test.gmap, which is absent from this repository (its assets are not
    shipped), not one the port's compiler cannot read."""

    map: str = "arena"
    batch: int = 4096
    ticks: int = 240
    width: int = 256
    height: int = 256
    render: bool = False
    devices: int = 0  # 0 = all
    seed: int = 0

    @staticmethod
    def from_cli(argv=None) -> "RunConfig":
        ap = argparse.ArgumentParser()
        d = RunConfig()
        ap.add_argument("--map", default=d.map)
        ap.add_argument("--batch", type=int, default=d.batch)
        ap.add_argument("--ticks", type=int, default=d.ticks)
        ap.add_argument("--width", type=int, default=d.width)
        ap.add_argument("--height", type=int, default=d.height)
        ap.add_argument("--render", action="store_true")
        ap.add_argument("--devices", type=int, default=0)
        ap.add_argument("--seed", type=int, default=0)
        ns = ap.parse_args(argv)
        return RunConfig(**vars(ns))
