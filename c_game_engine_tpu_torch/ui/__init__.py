"""UI stack (counterpart of c_game_engine_tpu/ui): the reference's
immediate-mode widget system as SoA tables.

`stack.py` holds the control-table compiler and the process/draw
functions; `screens.py` builds the game's menu screens on top of it
(game/src/gameState/*.c)."""

from c_game_engine_tpu_torch.ui.stack import (  # noqa: F401
    Anchor,
    ControlKind,
    UiInput,
    UiState,
    UiStackDef,
    build_stack,
    button,
    checkbox,
    init_ui_state,
    radio,
    slider,
    textbox,
    ui_draw,
    ui_process,
)
