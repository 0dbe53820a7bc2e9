"""Asset path resolution through the game's search paths (counterpart of
c_game_engine_tpu/compiler/models.py). Only `DEFAULT_SEARCH_PATHS` and
`AssetResolver.resolve` are ported, for the sound bank; `model()`,
`texture()` and `material()` (physics shapes and render data of models)
come with the compiler slice.

Search-path semantics follow game.gkvl: the 'game' directory, then
'assets/engine' (the reference's AssetReader.c:37-75). The defaults are
`assets/game` and `assets/engine` at the repository's root: the reference
engine's asset tree, put there by whoever has it. The repository does not
ship it; where it is absent every asset resolves to None.
"""

from __future__ import annotations

from pathlib import Path

_REFERENCE_ASSETS = Path(__file__).resolve().parents[2] / "assets"
DEFAULT_SEARCH_PATHS = (_REFERENCE_ASSETS / "game", _REFERENCE_ASSETS / "engine")


class AssetResolver:
    def __init__(self, search_paths=DEFAULT_SEARCH_PATHS):
        self.search_paths = [Path(p) for p in search_paths]

    def resolve(self, rel: str) -> Path | None:
        """The first search path's file `rel`, or None."""
        if not rel:
            return None
        for base in self.search_paths:
            p = base / rel
            if p.is_file():
                return p
        return None
