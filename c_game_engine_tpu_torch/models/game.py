"""Game application layer: the reference's screen state machine
(counterpart of c_game_engine_tpu/models/game.py; game/src/GameMain.c +
gameState/*.c) as a host-side loop around the batched sim:

  LOGO_SPLASH -> MENU -> LEVEL_SELECT -> LOADING -> IN_GAME <-> PAUSED
                   \\-> OPTIONS -> {VIDEO,SOUND,INPUT}_OPTIONS

Menu screens own a widget stack (ui/screens.py) processed by
`ui_tick(UiInput)` and drawn by `render_frame()`; explicit transition
methods (`open_level_select`, `pause`, ...) remain for scripted runs.
SaveData persists across maps and the menu can keep a background map.

Maps: a level is a `<name>.gmap` of `map_dir` (or a `.gmap` or editor
JSON path), compiled by the port's compiler and its bundle built, through
the compile cache (compiler/cache.py::load_compiled, its assets under
`search_paths`), as the JAX app compiles `.gmap` files and builds the
bundle; or a committed map of `map_dir` (default
c_game_engine_tpu_torch/maps/: `<name>.json` beside `<name>.npz`, the
`_bundle` files left out), loaded with core/state.py::load_map and its
committed bundle with render/bundle.py::load_bundle. `list_levels` lists
both. A committed map without a committed bundle (`arena`,
`arena_bodies`) gets one built when it is first drawn
(render/bundle.py::build_render_bundle over `search_paths`).

Departures from the JAX module:
  * The UI atlas and assets come from background_map's bundle when that
    is set, else from the current map's bundle where it is on file or
    compiled, else from arena_lit's (the JAX app reads test.gmap's).
  * `synthetic_assets=True` puts render/synthetic_hud.py's HUD, UI and
    viewmodel assets on every bundle whose atlas holds the textures they
    point at (arena_lit's; the committed bundles have none, so the screens
    would draw no widget); `sound_dir` is where the UI sounds
    are resolved (audio/synthetic_sounds.py writes stand-ins).
  * The tick: on a CUDA device each level's tick goes through the map's
    tick graph for the app's batch (models/graph.py; the JAX app's
    `jax.jit(step_batch)`), captured when the level loads; on the CPU it
    is the eager step_batch.
  * Frames go through render_with_hud / render (render graphs on a
    card); the env shown is taken as a batch of one, so the batch-of-one
    render graph serves every env.
  * UI audio is a channel table of one env ([1, 32] leaves) on the app's
    device, advanced with the compiler's frame counts of the builtin
    sounds (compiler/compile.py::_sound_lengths, as the JAX app reads them).
  * Host reads: `ui_tick` reads the fired events and, on an options
    screen, the option values on the host, once a UI frame (as the JAX
    app does). An in-game `tick` followed by `render_frame` reads nothing
    on the host on a card unless the debug overlay is on.
"""

from __future__ import annotations

import enum
import time
from pathlib import Path

import numpy as np
import torch

from c_game_engine_tpu_torch.core.actions import Actions
from c_game_engine_tpu_torch.core.state import load_map, tree_map
from c_game_engine_tpu_torch.models.sim import MAPS, change_map, reset_batch, step_one
from c_game_engine_tpu_torch.utils.config import Options
from c_game_engine_tpu_torch.utils.log import log_error, log_info
from c_game_engine_tpu_torch.utils.mathx import const

UI_FALLBACK_MAP = "arena_lit"  # the UI atlas when no map with a bundle is in use


class Screen(enum.Enum):
    LOGO_SPLASH = "logo_splash"
    MENU = "menu"
    LEVEL_SELECT = "level_select"
    LOADING = "loading"
    IN_GAME = "in_game"
    PAUSED = "paused"
    OPTIONS = "options"
    VIDEO_OPTIONS = "video_options"
    SOUND_OPTIONS = "sound_options"
    INPUT_OPTIONS = "input_options"


WIDGET_SCREENS = (Screen.MENU, Screen.PAUSED, Screen.OPTIONS, Screen.VIDEO_OPTIONS, Screen.SOUND_OPTIONS,
                  Screen.INPUT_OPTIONS)
OPTION_SCREENS = (Screen.OPTIONS, Screen.VIDEO_OPTIONS, Screen.SOUND_OPTIONS, Screen.INPUT_OPTIONS)

MIN_LOAD_TIME = 0.25  # LoadingState.c minimum display time


def _aniso_ratio(enum_val: int) -> int:
    """Options.anisotropy enum (0=off, 1=2x, 2=4x, 3=8x, 4=16x;
    Options.h:30-34) -> the sampler ratio render(aniso=...) takes."""
    return 0 if enum_val <= 0 else 2 ** min(int(enum_val), 4)


class GameApp:
    def __init__(self, map_dir: str | Path = MAPS, batch: int = 1, initial_map: str | None = None,
                 background_map: str | None = None, show_debug: bool = False, show_console: bool = False,
                 device="cuda", synthetic_assets: bool = False, sound_dir: str | Path | None = None,
                 search_paths=None):
        from c_game_engine_tpu_torch.compiler.models import DEFAULT_SEARCH_PATHS
        from c_game_engine_tpu_torch.audio.mixer import empty_audio
        from c_game_engine_tpu_torch.render.dprint import DPrintConsole

        self.map_dir = Path(map_dir)
        self.search_paths = DEFAULT_SEARCH_PATHS if search_paths is None else search_paths
        self.device = torch.device(device)
        # on-frame debug text (DPrint.h ENABLE_DEBUG_PRINT) + the last-2s
        # message console (--show-console, DPrintConsole.c:84-91)
        self.show_debug = show_debug
        self.console = DPrintConsole(enabled=show_console)
        self.batch = batch
        self.synthetic_assets = synthetic_assets
        self.sound_dir = sound_dir
        self.screen = Screen.LOGO_SPLASH
        self.cmap = None
        self.state = None
        self._current: str | None = None
        self._cmap_cache: dict[str, object] = {}
        self._bundle_cache: dict[str, object] = {}
        self._bg_state = {}
        self.background_map = background_map
        self.options = Options()
        self.request_exit = False
        self.selected_level = 0  # LevelSelectState.c:28
        self.splash_tick = 0
        self._options_in_game = False  # optionsStateInGame (OptionsState.c:30)
        self._ui = {}  # Screen -> [stackdef, event names, UiState]
        # app-layer UI/system sound channels (Button.c:55 click, MainState.c:47
        # popup, PauseState.c:36 popdown, LogoSplashState.c:26 coincling)
        self.ui_audio = tree_map(lambda x: x[None], empty_audio(self.device))
        self._ui_lengths = None
        self._ui_bank = None
        if initial_map:
            # --map flag: straight into loading (GameMain.c:14-39)
            self.load_level(initial_map)

    # ---- maps -------------------------------------------------------------
    def list_levels(self) -> list[str]:
        """The maps of map_dir: its `*.gmap` sources (LevelSelectState.c:126
        enumerates map/*.gmap) and its committed maps."""
        committed = {p.stem for p in self.map_dir.glob("*.npz")
                     if not p.stem.endswith("_bundle") and p.with_suffix(".json").exists()}
        return sorted(committed | {p.stem for p in self.map_dir.glob("*.gmap")})

    def _source(self, name: str) -> Path | None:
        """The `.gmap`/`.json` source a level compiles from, or None for a
        committed map."""
        if "/" in name or name.endswith((".gmap", ".json")):
            return Path(name)
        path = self.map_dir / f"{name}.gmap"
        return path if path.is_file() else None

    def _map(self, name: str):
        if name not in self._cmap_cache:
            src = self._source(name)
            if src is not None:
                from c_game_engine_tpu_torch.compiler.cache import load_compiled

                self._cmap_cache[name], bundle = load_compiled(src, self.search_paths, device=self.device)
                self._bundle_cache[name] = self._with_assets(bundle)
            else:
                self._cmap_cache[name] = load_map(self.map_dir / f"{name}.npz", self.map_dir / f"{name}.json",
                                                  self.device)
        return self._cmap_cache[name]

    def _with_assets(self, bundle):
        """The bundle with the synthetic HUD, UI and viewmodel assets when
        they are asked for and its atlas holds the textures they point at."""
        from c_game_engine_tpu_torch.render import synthetic_hud as sh

        if self.synthetic_assets and sh.TEXTURES <= set(bundle.tex_names):
            return sh.with_synthetic_hud(bundle)
        return bundle

    def has_bundle(self, name: str) -> bool:
        """Whether the level's bundle is on file or compiles with it (a
        committed map without one gets it built when drawn)."""
        return (self.map_dir / f"{name}_bundle.npz").exists() or self._source(name) is not None

    def _bundle_for(self, name: str):
        """(map, bundle) of a level: its compiled or committed bundle, or one
        built for a committed map without a bundle."""
        cmap = self._map(name)
        if name not in self._bundle_cache:
            from c_game_engine_tpu_torch.render.bundle import build_render_bundle, load_bundle

            if (self.map_dir / f"{name}_bundle.npz").exists():
                bundle = load_bundle(self.map_dir / f"{name}_bundle.npz", self.map_dir / f"{name}_bundle.json", cmap)
            else:
                from c_game_engine_tpu_torch.compiler.models import AssetResolver

                cmap.aux.setdefault("resolver", AssetResolver(self.search_paths))
                bundle = build_render_bundle(cmap)
            self._bundle_cache[name] = self._with_assets(bundle)
        return cmap, self._bundle_cache[name]

    def _ui_bundle(self):
        """The bundle whose atlas and UiAssets the screens draw with."""
        for name in (self.background_map, self._current):
            if name and self.has_bundle(name):
                return self._bundle_for(name)[1]
        return self._bundle_for(UI_FALLBACK_MAP)[1]

    # ---- transitions ------------------------------------------------------
    def advance_splash(self):
        assert self.screen == Screen.LOGO_SPLASH
        self.screen = Screen.MENU

    def open_level_select(self):
        assert self.screen == Screen.MENU
        self.screen = Screen.LEVEL_SELECT

    def load_level(self, name: str):
        """LoadingState: load + reset (ChangeMapByName, GlobalState.c:227-248),
        carrying SaveData when a run is active; on a card the level's tick
        graph is captured here."""
        self.screen = Screen.LOADING
        t_load = time.monotonic()
        try:
            new_cmap = self._map(name)
        except Exception as e:  # noqa: BLE001 - any load fault recovers
            # failed load: log and fall back to the menu (LoadingState.c:56-61)
            log_error("Failed to load map: %s (%s)", name, e)
            self.screen = Screen.MENU
            return
        self._current = name
        self.state = change_map(new_cmap, self.state) if self.state is not None else reset_batch(new_cmap, self.batch)
        self.cmap = new_cmap
        if self.device.type == "cuda":
            from c_game_engine_tpu_torch.models.graph import tick_graph

            tick_graph(new_cmap, self.state)
        # one physics tick before entering MainState (LoadingState.c:51-66)
        self.state = self._step(self.state, Actions.zeros((self.batch,), device=self.device))
        log_info("map %s loaded in %.0f ms", name, (time.monotonic() - t_load) * 1e3)
        self.screen = Screen.IN_GAME

    def _step(self, state, actions: Actions):
        """One tick of the batch: models/sim.py::step_one."""
        return step_one(self.cmap, state, actions)

    def pause(self):
        assert self.screen == Screen.IN_GAME
        self._play_ui("popup")  # MainState.c:47
        self.screen = Screen.PAUSED

    def resume(self):
        assert self.screen == Screen.PAUSED
        self._play_ui("popdown")  # PauseState.c:36
        self.screen = Screen.IN_GAME

    def quit_to_menu(self):
        self.screen = Screen.MENU

    # ---- per-tick ---------------------------------------------------------
    def tick(self, actions: Actions | None = None):
        """One fixed-timestep tick; only IN_GAME advances the world (the
        physics thread pauses the tick while not in MainState). `actions`
        [batch] on the app's device (zeros by default)."""
        if self.screen != Screen.IN_GAME:
            return self.state
        a = actions if actions is not None else Actions.zeros((self.batch,), device=self.device)
        self.state = self._step(self.state, a)
        return self.state

    # ---- widget screens ---------------------------------------------------
    # option-field bindings per screen: event name -> (Options field, kind)
    _VIDEO_BIND = {
        "fov": ("fov", float), "msaa": ("msaa", int), "anisotropy": ("anisotropy", int),
        "lod": ("lod_multiplier", float), "max_fps": ("max_fps", int),
        "fullscreen": ("fullscreen", bool), "vsync": ("vsync", bool),
        "limit_bg_fps": ("limit_fps_when_unfocused", bool), "mipmaps": ("mipmaps", bool),
        "prefer_wayland": ("prefer_wayland", bool),
    }
    _SOUND_BIND = {
        "master_volume": ("master_volume", float), "music_volume": ("music_volume", float),
        "sfx_volume": ("sfx_volume", float), "ui_volume": ("ui_volume", float),
    }
    _INPUT_BIND = {
        "sensitivity": ("camera_speed", float), "invert_h": ("invert_horizontal_camera", bool),
        "invert_v": ("invert_vertical_camera", bool), "rumble": ("rumble", bool),
        "swap_ok_cancel": ("swap_ok_cancel", bool),
    }

    def _ui_for(self, screen: Screen):
        """Lazy per-screen widget stack + state (the *StateSet fns)."""
        if screen not in self._ui:
            from c_game_engine_tpu_torch.ui import screens as scr
            from c_game_engine_tpu_torch.ui.stack import init_ui_state

            builders = {
                Screen.MENU: scr.menu_stack,
                Screen.PAUSED: scr.pause_stack,
                Screen.OPTIONS: scr.options_stack,
                Screen.VIDEO_OPTIONS: lambda: scr.video_options_stack(self.options),
                Screen.SOUND_OPTIONS: lambda: scr.sound_options_stack(self.options),
                Screen.INPUT_OPTIONS: lambda: scr.input_options_stack(self.options),
            }
            sd, events = builders[screen]()
            self._ui[screen] = [sd, events, init_ui_state(sd, device=self.device)]
        return self._ui[screen]

    def _set_screen(self, screen: Screen):
        """SetGameState: entering a widget screen resets its focus
        (UiStackResetFocus in every *StateSet)."""
        self.screen = screen
        if screen in WIDGET_SCREENS:
            ui = self._ui_for(screen)
            full = lambda v: torch.full((), v, dtype=torch.int32, device=self.device)
            ui[2] = ui[2].replace(focused=full(-1), active=full(-1), active_state=full(0))

    def _sync_options(self, screen: Screen, events, st):
        bind = {Screen.VIDEO_OPTIONS: self._VIDEO_BIND, Screen.SOUND_OPTIONS: self._SOUND_BIND,
                Screen.INPUT_OPTIONS: self._INPUT_BIND}.get(screen)
        if not bind:
            return
        values = st.value.cpu().numpy()
        checked = st.checked.cpu().numpy()
        for i, ev in enumerate(events):
            if ev in bind:
                field, kind = bind[ev]
                setattr(self.options, field, bool(checked[i]) if kind is bool else kind(values[i]))

    def ui_tick(self, inp=None):
        """One frame of the active screen's Update + ProcessUiStack,
        dispatching activation events to screen transitions (the reference's
        button callbacks). Pass a ui.stack.UiInput (on the host); defaults
        to no input. Returns the fired event names."""
        from c_game_engine_tpu_torch.ui.stack import UiInput, ui_process

        if inp is None:
            inp = UiInput.none()
        esc = bool(inp.escape)
        scr = self.screen
        self._advance_ui_audio()

        if scr == Screen.LOGO_SPLASH:
            # LogoSplashState: any key (or 100 ticks) -> menu
            self.splash_tick += 1
            if self.splash_tick == 20:
                from c_game_engine_tpu_torch.audio.mixer import CATEGORY_SFX

                self._play_ui("coincling", CATEGORY_SFX)  # LogoSplashState.c:24-27
            if self.splash_tick > 100 or esc or bool(inp.space) or bool(inp.enter):
                self._set_screen(Screen.MENU)
            return []

        if scr == Screen.LEVEL_SELECT:
            # LevelSelectState.c:31-64 (custom scroll list, not a UiStack)
            names = self.list_levels()
            if esc:
                self._set_screen(Screen.MENU)
                return []
            if len(names) > 1:
                if bool(inp.down) or bool(inp.dpad_down):
                    self.selected_level = (self.selected_level + 1) % len(names)
                elif bool(inp.up) or bool(inp.dpad_up):
                    self.selected_level = (self.selected_level - 1) % len(names)
            if names and (bool(inp.space) or bool(inp.ok_released)):
                self.load_level(names[self.selected_level])
            return []

        if scr == Screen.PAUSED and esc:
            self.resume()  # PauseStateUpdate (PauseState.c:32-38)
            return []
        if scr == Screen.OPTIONS and esc:
            self._back_from_options()
            return []
        if scr in OPTION_SCREENS[1:] and esc:
            self._set_screen(Screen.OPTIONS)
            return []
        if scr == Screen.IN_GAME:
            if esc:
                self.pause()
            return []
        if scr not in WIDGET_SCREENS:
            return []

        ui = self._ui_for(scr)
        sd, events, st = ui
        st, activated = ui_process(sd, st, inp)
        ui[2] = st
        self._sync_options(scr, events, st)
        fired = [events[i] for i in np.nonzero(activated.cpu().numpy())[0]]
        for ev in fired:
            self._dispatch(scr, ev)
        return fired

    def _back_from_options(self):
        """BtnOptionsBack (OptionsState.c:32-42)."""
        self._set_screen(Screen.PAUSED if self._options_in_game else Screen.MENU)

    # ---- UI audio ---------------------------------------------------------
    # index into audio.bank.BUILTIN_SOUNDS
    _UI_SOUND_IDS = {"click": 0, "popup": 1, "popdown": 2, "coincling": 3}

    def _bank(self):
        """The UI sounds' bank (BUILTIN_SOUNDS resolved under sound_dir, or
        the app's search paths) and their frame counts."""
        from c_game_engine_tpu_torch.audio.bank import BUILTIN_SOUNDS, build_sound_bank
        from c_game_engine_tpu_torch.compiler.compile import _sound_lengths
        from c_game_engine_tpu_torch.compiler.models import AssetResolver

        resolver = AssetResolver([self.sound_dir]) if self.sound_dir else AssetResolver(self.search_paths)
        if self._ui_bank is None:
            self._ui_bank = build_sound_bank(resolver, BUILTIN_SOUNDS, self.device)
        if self._ui_lengths is None:
            # what the compiler gives a level (CompiledMap.sound_len), as the
            # JAX app reads them
            self._ui_lengths = torch.as_tensor(_sound_lengths(resolver, BUILTIN_SOUNDS), device=self.device)
        return self._ui_bank

    def _play_ui(self, name: str, category: int | None = None):
        from c_game_engine_tpu_torch.audio.mixer import CATEGORY_UI, alloc_channels

        dev = self.device
        cat = CATEGORY_UI if category is None else category
        self.ui_audio, _ = alloc_channels(
            self.ui_audio,
            const(((True,),), dev, torch.bool),
            const(((self._UI_SOUND_IDS[name],),), dev, torch.int32),
            const(((1.0,),), dev),
            const(((cat,),), dev, torch.int32),
            const(((0,),), dev, torch.int32),
            const(((False,),), dev, torch.bool),
            const((((0.0, 0.0, 0.0),),), dev),
        )

    def _advance_ui_audio(self):
        from c_game_engine_tpu_torch.audio.mixer import tick_advance

        if self._ui_lengths is None:
            self._bank()
        self.ui_audio, _ = tick_advance(self.ui_audio, self._ui_lengths)

    def mix_ui_audio(self, n_samples: int):
        """Render the app-layer sounds as [n, 2] f32 (host demo output)."""
        from c_game_engine_tpu_torch.audio.mixer import mix_frame

        o = self.options
        dev = self.device
        vols = torch.tensor([o.master_volume, o.music_volume, o.sfx_volume, o.ui_volume], dtype=torch.float32,
                            device=dev)
        return mix_frame(self._bank(), self.ui_audio, const(((0.0, 0.0, 0.0),), dev),
                         const(((0.0, 0.0, 0.0, 1.0),), dev), vols, n_samples)[0]

    def _dispatch(self, screen: Screen, ev: str):
        self._play_ui("click")  # uiStack control activation (Button.c:55)
        if screen == Screen.MENU:
            if ev == "start":
                self.open_level_select()
            elif ev == "options":
                self._options_in_game = False
                self._set_screen(Screen.OPTIONS)
            elif ev == "quit":
                self.request_exit = True  # QuitGame (MenuState.c:37-40)
            elif ev == "reload_assets":
                self._cmap_cache.clear()
                self._bundle_cache.clear()
                self._bg_state.clear()
        elif screen == Screen.PAUSED:
            if ev == "resume":
                self.resume()
            elif ev == "options":
                self._options_in_game = True
                self._set_screen(Screen.OPTIONS)
            elif ev == "exit_level":
                # BtnPauseExit: ChangeMap(NULL) + LevelSelect (PauseState.c:74-78)
                self._set_screen(Screen.LEVEL_SELECT)
        elif screen == Screen.OPTIONS:
            if ev == "video":
                self._set_screen(Screen.VIDEO_OPTIONS)
            elif ev == "sound":
                self._set_screen(Screen.SOUND_OPTIONS)
            elif ev == "input":
                self._set_screen(Screen.INPUT_OPTIONS)
            elif ev == "back":
                self._back_from_options()
        elif screen in OPTION_SCREENS[1:]:
            if ev == "back":
                self._set_screen(Screen.OPTIONS)

    # ---- frames -----------------------------------------------------------
    def _menu_background(self, height, width):
        """RenderMenuBackground: live view of the background map
        (BackgroundMapManager.c:25-119); black while unset."""
        if not self.background_map:
            return torch.zeros((height, width, 3), dtype=torch.float32, device=self.device)
        from c_game_engine_tpu_torch.core.state import reset
        from c_game_engine_tpu_torch.render.raster import render

        cmap, bundle = self._bundle_for(self.background_map)
        if self.background_map not in self._bg_state:
            self._bg_state[self.background_map] = reset(cmap)
        return render(bundle, cmap, self._bg_state[self.background_map], height, width)

    def _game_frame(self, height, width, env):
        """The current level's env `env` with its HUD, [H, W, 3]."""
        from c_game_engine_tpu_torch.render.raster import render_with_hud_batch

        cmap, bundle = self._bundle_for(self._current)
        env_state = tree_map(lambda x: x[env:env + 1], self.state)
        frame = render_with_hud_batch(bundle, cmap, env_state, height, width, mipmaps=self.options.mipmaps,
                                      aniso=_aniso_ratio(self.options.anisotropy))[0]
        return frame, cmap, bundle, env_state

    def render_frame(self, height=256, width=256, env=0):
        """Pixels for the current screen (the reference's RenderGame fns).
        Returns f32 [H, W, 3] on the app's device."""
        from c_game_engine_tpu_torch.ui import screens as scr

        s = self.screen
        if s in (Screen.IN_GAME, Screen.PAUSED):
            frame, cmap, bundle, env_state = self._game_frame(height, width, env)
            if self.show_debug or self.console.enabled:
                # MainStateRender debug tail (MainState.c:100-109) + the
                # console's last-2s messages (ProcessDPrintConsole)
                from c_game_engine_tpu_torch.render.dprint import dprint_overlay, standard_debug_lines

                lines = standard_debug_lines(cmap, tree_map(lambda x: x[0], env_state)) if self.show_debug else []
                lines += self.console.process(time.monotonic() * 1e3)
                frame = dprint_overlay(frame, bundle.atlas, bundle.ui, lines)
            if s == Screen.IN_GAME:
                return frame
            ui_bundle = self._ui_bundle()
            sd, _, st = self._ui_for(Screen.PAUSED)
            return scr.render_pause_screen(frame, ui_bundle.atlas, ui_bundle.ui, sd, st)

        ui_bundle = self._ui_bundle()
        atlas, ui_assets = ui_bundle.atlas, ui_bundle.ui
        if s == Screen.LOGO_SPLASH:
            black = torch.zeros((height, width, 3), dtype=torch.float32, device=self.device)
            return scr.render_splash_screen(black, atlas, ui_assets, self.splash_tick)
        if s == Screen.MENU:
            sd, _, st = self._ui_for(Screen.MENU)
            return scr.render_menu_screen(self._menu_background(height, width), atlas, ui_assets, sd, st)
        if s == Screen.LEVEL_SELECT:
            return scr.render_level_select_screen(self._menu_background(height, width), atlas, ui_assets,
                                                  self.list_levels(), self.selected_level)
        if s in OPTION_SCREENS:
            titles = {Screen.OPTIONS: "Options", Screen.VIDEO_OPTIONS: "Video Options",
                      Screen.SOUND_OPTIONS: "Sound Options", Screen.INPUT_OPTIONS: "Input Options"}
            sd, _, st = self._ui_for(s)
            if self._options_in_game and self.state is not None:
                bg = scr.draw_rect(self._game_frame(height, width, env)[0], 0, 0, width, height,
                                   (0.0, 0.0, 0.0, 0.5))
            else:
                bg = self._menu_background(height, width)
            return scr.render_options_screen(bg, atlas, ui_assets, sd, st, titles[s])
        # LOADING: centered "LOADING" text over black (LoadingState.c:77-85)
        return scr.render_loading_screen(self._menu_background(height, width), atlas, ui_assets)
