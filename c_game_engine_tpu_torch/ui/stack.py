"""Widget stack as SoA tables + pure process/draw functions (counterpart of
c_game_engine_tpu/ui/stack.py, the reference's engine/src/uiStack/).

A screen's controls compile once into static tables (`UiStackDef`), the
mutable widget state is a small dataclass of tensors (`UiState`), and one
`ui_process` call per frame reproduces the reference's hover, focus and
activation rules and the per-kind updates (button, slider, checkbox,
radio, textbox); see the JAX module for the citations. Activation
"callbacks" come back as an `activated [N] bool` event vector the host
game layer dispatches on.

The stack's tables stay on the host (numpy): `ui_draw` loops over the
controls and reads each one's kind and rect as numbers, so a device copy
would cost a host read per control per frame. `ui_process` takes them to
the state's device once per device (`UiStackDef.on`). A `UiInput` lives
on the host too (the game layer reads its keys there); `ui_process` moves
it to the state's device in three copies.

Coordinates are the reference's virtual 640 x 480 space; `ui_draw` maps
them onto the frame [H, W, 3].
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass

import numpy as np
import torch

from c_game_engine_tpu_torch.core.state import Struct
from c_game_engine_tpu_torch.utils.mathx import const

MAX_TEXT = 40  # label / textbox capacity (codes, -1 = pad)
MAX_INSERT = 8  # host text-input codes per tick

# virtual design space (reference layouts target this scaled size)
VIRTUAL_W = 640.0
VIRTUAL_H = 480.0


class ControlKind(enum.IntEnum):
    BUTTON = 0
    SLIDER = 1
    CHECKBOX = 2
    RADIO = 3
    TEXTBOX = 4


class Anchor(enum.IntEnum):
    TOP_LEFT = 0
    TOP_CENTER = 1
    TOP_RIGHT = 2
    MIDDLE_LEFT = 3
    MIDDLE_CENTER = 4
    MIDDLE_RIGHT = 5
    BOTTOM_LEFT = 6
    BOTTOM_CENTER = 7
    BOTTOM_RIGHT = 8


@dataclass
class ControlSpec:
    kind: ControlKind
    pos: tuple
    size: tuple
    label: str = ""
    anchor: Anchor = Anchor.TOP_LEFT
    # slider params (Slider.c)
    vmin: float = 0.0
    vmax: float = 1.0
    value: float = 0.0
    step: float = 0.1
    alt_step: float = 0.1
    percent: bool = False  # SliderLabelPercent formatting
    # checkbox / radio
    checked: bool = False
    group: int = 0
    rid: int = 0
    # textbox
    max_len: int = MAX_TEXT
    placeholder: str = ""


def button(pos, size, label, anchor=Anchor.TOP_LEFT):
    return ControlSpec(ControlKind.BUTTON, pos, size, label, anchor)


def slider(pos, size, label, anchor, vmin, vmax, value, step, alt_step, percent=False):
    return ControlSpec(
        ControlKind.SLIDER, pos, size, label, anchor,
        vmin=vmin, vmax=vmax, value=float(np.clip(value, vmin, vmax)),
        step=step, alt_step=alt_step, percent=percent,
    )


def checkbox(pos, size, label, anchor, checked=False):
    return ControlSpec(ControlKind.CHECKBOX, pos, size, label, anchor, checked=checked)


def radio(pos, size, label, anchor, checked, group, rid):
    return ControlSpec(ControlKind.RADIO, pos, size, label, anchor, checked=checked, group=group, rid=rid)


def textbox(pos, size, placeholder, anchor, max_len=MAX_TEXT - 1):
    return ControlSpec(
        ControlKind.TEXTBOX, pos, size, "", anchor,
        max_len=min(max_len, MAX_TEXT - 1), placeholder=placeholder,
    )


def _codes(s: str) -> np.ndarray:
    out = np.full(MAX_TEXT, -1, np.int32)
    for i, ch in enumerate(s[:MAX_TEXT]):
        out[i] = min(ord(ch), 127)
    return out


def _anchored(spec: ControlSpec) -> tuple:
    """CalculateControlPosition (UiStack.c:277-321) in virtual units."""
    px, py = spec.pos
    w, h = spec.size
    ax = {0: 0.0, 1: (VIRTUAL_W - w) / 2, 2: VIRTUAL_W - w}[int(spec.anchor) % 3]
    ay = {0: 0.0, 1: (VIRTUAL_H - h) / 2, 2: VIRTUAL_H - h}[int(spec.anchor) // 3]
    return ax + px, ay + py


@dataclass(eq=False)
class UiStackDef:
    """A screen's controls as host tables (numpy), in control order."""

    kind: np.ndarray  # [N] i32
    rect: np.ndarray  # [N, 4] f32 anchored x, y, w, h (virtual units)
    label: np.ndarray  # [N, MAX_TEXT] i32 codes
    vmin: np.ndarray  # [N] f32
    vmax: np.ndarray  # [N]
    step: np.ndarray  # [N]
    alt_step: np.ndarray  # [N]
    percent: np.ndarray  # [N] bool
    group: np.ndarray  # [N] i32
    rid: np.ndarray  # [N] i32
    max_len: np.ndarray  # [N] i32
    placeholder: np.ndarray  # [N, MAX_TEXT] i32
    init_value: np.ndarray  # [N] f32
    init_checked: np.ndarray  # [N] bool
    _device_copies: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n(self):
        return self.kind.shape[0]

    def on(self, device) -> "UiStackDef":
        """The same tables as tensors on `device`, made once per device."""
        device = torch.device(device)
        if device not in self._device_copies:
            fields = {f.name: torch.from_numpy(np.array(getattr(self, f.name))).to(device)
                      for f in dataclasses.fields(self) if f.name != "_device_copies"}
            self._device_copies[device] = UiStackDef(**fields)
        return self._device_copies[device]


@dataclass
class UiState(Struct):
    focused: torch.Tensor  # [] i32, -1 = none
    active: torch.Tensor  # [] i32, -1 = none (hovered / pressed control)
    active_state: torch.Tensor  # [] i32: 0 NORMAL, 1 HOVER, 2 ACTIVE
    value: torch.Tensor  # [N] f32 slider values
    checked: torch.Tensor  # [N] bool
    text: torch.Tensor  # [N, MAX_TEXT] i32 codes, -1 pad
    cursor: torch.Tensor  # [N] i32


def _false():
    return torch.zeros((), dtype=torch.bool)


@dataclass
class UiInput(Struct):
    """One tick of UI-relevant input (virtual-space mouse), [] bool keys,
    on the host unless moved."""

    mouse: torch.Tensor  # [2] f32
    mouse_down: torch.Tensor = dataclasses.field(default_factory=_false)
    mouse_pressed: torch.Tensor = dataclasses.field(default_factory=_false)
    mouse_released: torch.Tensor = dataclasses.field(default_factory=_false)
    tab: torch.Tensor = dataclasses.field(default_factory=_false)
    shift: torch.Tensor = dataclasses.field(default_factory=_false)
    space: torch.Tensor = dataclasses.field(default_factory=_false)
    enter: torch.Tensor = dataclasses.field(default_factory=_false)
    left: torch.Tensor = dataclasses.field(default_factory=_false)
    right: torch.Tensor = dataclasses.field(default_factory=_false)
    up: torch.Tensor = dataclasses.field(default_factory=_false)
    down: torch.Tensor = dataclasses.field(default_factory=_false)
    escape: torch.Tensor = dataclasses.field(default_factory=_false)
    home: torch.Tensor = dataclasses.field(default_factory=_false)
    end: torch.Tensor = dataclasses.field(default_factory=_false)
    backspace: torch.Tensor = dataclasses.field(default_factory=_false)
    delete: torch.Tensor = dataclasses.field(default_factory=_false)
    controller: torch.Tensor = dataclasses.field(default_factory=_false)
    ok_pressed: torch.Tensor = dataclasses.field(default_factory=_false)
    ok_released: torch.Tensor = dataclasses.field(default_factory=_false)
    dpad_up: torch.Tensor = dataclasses.field(default_factory=_false)
    dpad_down: torch.Tensor = dataclasses.field(default_factory=_false)
    dpad_left: torch.Tensor = dataclasses.field(default_factory=_false)
    dpad_right: torch.Tensor = dataclasses.field(default_factory=_false)
    text: torch.Tensor = dataclasses.field(default_factory=lambda: torch.full((MAX_INSERT,), -1, dtype=torch.int32))

    @classmethod
    def at_mouse(cls, x, y, **kw):
        kw = {k: torch.as_tensor(np.asarray(v)) for k, v in kw.items()}
        return cls(mouse=torch.tensor([x, y], dtype=torch.float32), **kw)

    @classmethod
    def none(cls):
        return cls(mouse=torch.tensor([-1.0, -1.0], dtype=torch.float32))

    def to(self, device) -> "UiInput":
        """The input on `device`: the keys go over as one tensor."""
        device = torch.device(device)
        if self.mouse.device == device:
            return self
        keys = torch.stack([getattr(self, k).to(torch.bool) for k in _KEYS]).to(device)
        return UiInput(mouse=self.mouse.to(device), text=self.text.to(device),
                       **{k: keys[i] for i, k in enumerate(_KEYS)})


_KEYS = tuple(f.name for f in dataclasses.fields(UiInput) if f.name not in ("mouse", "text"))  # the [] bool keys


def build_stack(controls: list) -> UiStackDef:
    arr = lambda attr, dtype: np.array([getattr(c, attr) for c in controls], dtype)
    return UiStackDef(
        kind=np.array([int(c.kind) for c in controls], np.int32),
        rect=np.array([[*_anchored(c), c.size[0], c.size[1]] for c in controls], np.float32),
        label=np.stack([_codes(c.label) for c in controls]),
        vmin=arr("vmin", np.float32),
        vmax=arr("vmax", np.float32),
        step=arr("step", np.float32),
        alt_step=arr("alt_step", np.float32),
        percent=arr("percent", bool),
        group=arr("group", np.int32),
        rid=arr("rid", np.int32),
        max_len=arr("max_len", np.int32),
        placeholder=np.stack([_codes(c.placeholder) for c in controls]),
        init_value=arr("value", np.float32),
        init_checked=arr("checked", bool),
    )


def init_ui_state(sd: UiStackDef, use_controller: bool = False, device="cuda") -> UiState:
    """UiStackResetFocus (UiStack.c:377-380): controller users start with
    the first control focused, mouse users with none. The state lives on
    `device` (the card unless the caller asks for the CPU)."""
    n = sd.n
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    return UiState(
        focused=i32(0 if use_controller else -1),
        active=i32(-1),
        active_state=i32(0),
        value=torch.from_numpy(sd.init_value.copy()).to(device),
        checked=torch.from_numpy(sd.init_checked.copy()).to(device),
        text=torch.full((n, MAX_TEXT), -1, dtype=torch.int32, device=device),
        cursor=torch.zeros(n, dtype=torch.int32, device=device),
    )


def _last_true(mask):
    """Index of the last set entry of a [N] bool mask (the reverse-order
    scan; any index when none is set)."""
    n = mask.shape[0]
    return n - 1 - torch.argmax(torch.flip(mask, (0,)).to(torch.int32))


def ui_process(sd: UiStackDef, st: UiState, inp: UiInput):
    """One frame of ProcessUiStack + control updates on the state's device.
    Returns (new UiState, activated [N] bool event vector)."""
    dev = st.value.device
    sd, inp = sd.on(dev), inp.to(dev)
    n = sd.n
    idx = torch.arange(n, device=dev)
    x0, y0 = sd.rect[:, 0], sd.rect[:, 1]
    w, h = sd.rect[:, 2], sd.rect[:, 3]
    mx, my = inp.mouse[0], inp.mouse[1]
    in_rect = (mx >= x0) & (mx <= x0 + w) & (my >= y0) & (my <= y0 + h)

    # hover pick: last (topmost) overlapping control (UiStack.c:168-192)
    hover = torch.where(in_rect.any(), _last_true(in_rect), -1).to(torch.int32)

    # controller mode pins hover to the focused control (UiStack.c:157-164)
    focused = st.focused
    focused = torch.where(inp.controller & (focused < 0), 0, focused)
    active = torch.where(inp.controller, focused, hover)

    press = torch.where(inp.controller, inp.ok_pressed, inp.mouse_pressed | inp.space | inp.ok_pressed)
    has_active = active >= 0
    active_state = torch.where(has_active, torch.where(press, 2, 1), 0).to(torch.int32)
    # pressing over a control focuses it (UiStack.c:146-152, 179-186)
    focused = torch.where(press & has_active, active, focused)

    # ---- activation events (HasActivation, UiStack.c:343-375) ----
    mouse_act = (idx == active) & in_rect & inp.mouse_released & ~inp.controller
    key_act = (idx == focused) & (inp.enter | inp.space | inp.ok_released)
    activated = mouse_act | key_act

    # ---- checkbox toggle (CheckBox.c:51-69) ----
    is_cb = sd.kind == int(ControlKind.CHECKBOX)
    checked = st.checked ^ (activated & is_cb)

    # ---- radio select + group unique (RadioButton.c:56-94) ----
    is_radio = sd.kind == int(ControlKind.RADIO)
    r_act = activated & is_radio
    any_r = r_act.any()
    # highest activated index wins if several fire in one tick
    r_sel = torch.where(any_r, _last_true(r_act), -1)
    same_group = sd.group == sd.group[torch.clamp(r_sel, 0, n - 1)]
    checked = torch.where(any_r & is_radio & same_group, idx == r_sel, checked)

    # ---- slider (Slider.c:98-181) ----
    is_sl = sd.kind == int(ControlKind.SLIDER)
    f_sl = is_sl & (idx == focused)
    step_l = inp.left | inp.dpad_left
    step_r = inp.right | inp.dpad_right
    value = st.value
    value = torch.where(f_sl & step_l, value - sd.step, value)
    value = torch.where(f_sl & step_r, value + sd.step, value)
    # mouse drag on the hovered slider while held: remap + snap to step
    drag = is_sl & (idx == active) & inp.mouse_down & ~inp.controller
    raw = sd.vmin + (mx - x0) / torch.clamp_min(w, 1e-6) * (sd.vmax - sd.vmin)
    snap = torch.where(inp.shift, sd.alt_step, sd.step)
    snapped = torch.round(raw / torch.clamp_min(snap, 1e-9)) * snap  # half to even, as jnp.round
    value = torch.where(drag, snapped, value)
    value = torch.minimum(torch.maximum(value, sd.vmin), sd.vmax)

    # ---- textbox (TextBox.c:82-212) ----
    is_tb = sd.kind == int(ControlKind.TEXTBOX)
    f_tb = is_tb & (idx == focused)
    tlen = (st.text >= 0).to(torch.int32).sum(1)
    cursor = st.cursor
    cursor = torch.where(f_tb & inp.left, cursor - 1, cursor)
    cursor = torch.where(f_tb & inp.right, cursor + 1, cursor)
    cursor = torch.where(f_tb & inp.home, 0, cursor)
    cursor = torch.where(f_tb & inp.end, tlen, cursor)
    cursor = torch.minimum(torch.clamp_min(cursor, 0), tlen)

    pos = torch.arange(MAX_TEXT, device=dev)[None, :]
    pad = torch.full((n, 1), -1, dtype=torch.int32, device=dev)
    text = st.text
    # backspace: close the gap at cursor-1
    bs_row = f_tb & inp.backspace & (cursor > 0)
    text = torch.where(bs_row[:, None] & (pos >= cursor[:, None] - 1), torch.cat([text[:, 1:], pad], 1), text)
    cursor = torch.where(bs_row, cursor - 1, cursor)
    # delete: close the gap at cursor
    dl = (f_tb & inp.delete)[:, None]
    text = torch.where(dl & (pos >= cursor[:, None]), torch.cat([text[:, 1:], pad], 1), text)
    # insert host text codes at the cursor (TextBoxTextInputCallback)
    k = (inp.text >= 0).to(torch.int32).sum()
    tlen = (text >= 0).to(torch.int32).sum(1)
    k_row = torch.minimum(k, sd.max_len - tlen)  # truncate at maxLength
    cur = cursor[:, None]
    combined = torch.cat([text, inp.text[None].expand(n, MAX_INSERT)], 1)
    src = torch.where(pos < cur, pos,
                      torch.where(pos < cur + k_row[:, None], MAX_TEXT + (pos - cur), pos - k_row[:, None]))
    inserted = torch.gather(combined, 1, torch.clamp(src, 0, MAX_TEXT + MAX_INSERT - 1).long())
    do_ins = (f_tb & (k > 0))[:, None]
    text = torch.where(do_ins & (pos < sd.max_len[:, None]), inserted, text)
    cursor = torch.where(f_tb & (k > 0), cursor + k_row, cursor)

    # ---- tab / dpad focus cycling (UiStack.c:196-217) ----
    fwd = (inp.tab & ~inp.shift) | inp.dpad_down
    bwd = (inp.tab & inp.shift) | inp.dpad_up
    focused = torch.where(fwd, torch.where(focused < 0, 0, (focused + 1) % n), focused)  # floor modulo
    focused = torch.where(bwd, torch.where(focused <= 0, n - 1, focused - 1), focused)

    new = UiState(
        focused=focused.to(torch.int32),
        active=active.to(torch.int32),
        active_state=active_state,
        value=value,
        checked=checked,
        text=text,
        cursor=cursor.to(torch.int32),
    )
    return new, activated


# ---------------------------------------------------------------------------
# drawing
# ---------------------------------------------------------------------------

# UiAssets texture slots (copied from c_game_engine_tpu/ui/stack.py; the
# JAX render/bundle.py fills them from assets/engine/texture/interface/)
UITEX_BUTTON = 0
UITEX_BUTTON_HOVER = 1
UITEX_BUTTON_PRESSED = 2
UITEX_SLIDER = 3
UITEX_SLIDER_THUMB = 4
UITEX_CHECKBOX_UNCHECKED = 5
UITEX_CHECKBOX_CHECKED = 6
UITEX_RADIO_UNCHECKED = 7
UITEX_RADIO_CHECKED = 8
UITEX_TEXTBOX = 9
UITEX_FOCUS_RECT = 10
UITEX_MENU_LOGO = 11
UITEX_PAUSE_LOGO = 12
UITEX_STUDIO = 13
NUM_UITEX = 14


@dataclass
class UiAssets(Struct):
    tex: torch.Tensor  # [NUM_UITEX] i32 atlas ids (-1 = missing)
    tex_size: torch.Tensor  # [NUM_UITEX, 2] f32 texture pixel dims
    # small font (font/small_font.gfon; the reference's widget font), the
    # font_* fields render/hud.py::draw_text reads
    font_tex: torch.Tensor
    font_start_u: torch.Tensor  # [128]
    font_end_u: torch.Tensor  # [128]
    font_widths: torch.Tensor  # [128]
    font_height: torch.Tensor
    font_spacing: torch.Tensor


UI_FIELDS = tuple(f.name for f in dataclasses.fields(UiAssets))


def draw_ninepatch(frame, atlas, ui: UiAssets, slot, x0, y0, w, h, corner):
    """DrawNinePatchTexture over frame [H, W, 3]: corners keep their pixel
    size, edges/center stretch. The rect is in frame pixels (numbers or []
    tensors); slot an int or a [] tensor."""
    from c_game_engine_tpu_torch.render.textures import sample

    dev = frame.device
    tex_id = ui.tex[slot]
    tw = ui.tex_size[slot, 0]
    th = ui.tex_size[slot, 1]
    fh, fw = frame.shape[:2]
    ys = torch.arange(fh, dtype=torch.float32, device=dev)[:, None] - y0
    xs = torch.arange(fw, dtype=torch.float32, device=dev)[None, :] - x0

    def axis_uv(p, size, t_size):
        c = torch.clamp_max(t_size * 0.5, corner)
        lo = p < c
        hi = p > size - c
        t1 = torch.clamp_min(t_size, 1.0)
        u_lo = p / t1
        u_hi = 1.0 - (size - p) / t1
        u_mid = (c + (p - c) / torch.clamp_min(size - 2 * c, 1e-6) * (t_size - 2 * c)) / t1
        return torch.where(lo, u_lo, torch.where(hi, u_hi, u_mid))

    u, v = torch.broadcast_tensors(axis_uv(xs, w, tw), axis_uv(ys, h, th))
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h) & (tex_id >= 0)
    rgba = sample(atlas, tex_id.expand(u.shape), torch.stack([u, v], -1))
    a = torch.where(inside, rgba[..., 3], 0.0)[..., None]
    return frame * (1 - a) + rgba[..., :3] * a


def _slider_value_codes(sd, st, i):
    """Default/percent slider labels (Slider.c:25-50): ': 1.23' / ': 57%'.
    sd on the state's device; returns [8] i32."""
    val = st.value[i]
    pct = sd.percent[i]
    shown = torch.where(pct, torch.round(val * 100.0), torch.round(val * 100.0) / 100.0)
    whole = torch.floor(shown).to(torch.int32)
    frac = torch.round((torch.where(pct, 0.0, shown) - whole) * 100.0).to(torch.int32)
    frac = torch.clamp(frac, 0, 99)

    def dig(v, p):
        return torch.div(v, p, rounding_mode="floor") % 10 + 48

    d100, d10, d1 = dig(whole, 100), dig(whole, 10), dig(whole, 1)
    blank = -1
    codes = (
        torch.full_like(d1, ord(":")),
        torch.full_like(d1, ord(" ")),
        torch.where(whole >= 100, d100, blank),
        torch.where(whole >= 10, d10, blank),
        d1,
        torch.where(pct, ord("%"), ord(".")),
        torch.where(pct, blank, dig(frac, 10)),
        torch.where(pct, blank, dig(frac, 1)),
    )
    return torch.stack([c.to(torch.int32) for c in codes])


def draw_text1(frame, atlas, font, codes, x, y, size, color, halign="left"):
    """render/hud.py::draw_text on one frame [H, W, 3] (a batch of one)."""
    from c_game_engine_tpu_torch.render.hud import draw_text

    return draw_text(frame[None], atlas, font, codes, x, y, size, color, halign)[0]


def ui_draw(sd: UiStackDef, st: UiState, atlas, ui: UiAssets, frame):
    """DrawUiStack (UiStack.c:256-275) over `frame` [H, W, 3]. Virtual
    coordinates scale to the frame size. The loop reads the host tables
    only; every state-dependent choice is a tensor select on the device."""
    dev = frame.device
    sdd = sd.on(dev)
    fh, fw = frame.shape[:2]
    sx_ = fw / VIRTUAL_W
    sy_ = fh / VIRTUAL_H
    scale = min(sx_, sy_)
    out = frame
    font_size = 16.0 * scale
    black = const((0.0, 0.0, 0.0, 1.0), dev)
    white = const((1.0, 1.0, 1.0, 1.0), dev)
    gray = const((0.75, 0.75, 0.75, 1.0), dev)
    faint = const((0.0, 0.0, 0.0, 0.5), dev)
    for i in range(sd.n):
        k = int(sd.kind[i])
        # float32 arithmetic, as the JAX function's f32 tables with weak scalars
        x0 = sd.rect[i, 0] * np.float32(sx_)
        y0 = sd.rect[i, 1] * np.float32(sy_)
        w = sd.rect[i, 2] * np.float32(sx_)
        h = sd.rect[i, 3] * np.float32(sy_)
        state_i = torch.where(st.active == i, st.active_state, 0)
        label = sdd.label[i]
        # a label drawn alone loses its -1 pads (no advance, nothing drawn):
        # its glyphs' positions are the same prefix sums
        whole = sdd.label[i, :max(1, int((sd.label[i] >= 0).sum()))]
        cx = x0 + w / np.float32(2)
        cy = y0 + (h - np.float32(font_size)) / np.float32(2)

        if k == int(ControlKind.BUTTON):
            slot = UITEX_BUTTON + (state_i == 1).to(torch.int32) * 1 + (state_i == 2).to(torch.int32) * 2
            out = draw_ninepatch(out, atlas, ui, slot, x0, y0, w, h, 8.0 * scale)
            out = draw_text1(out, atlas, ui, whole, cx, cy, font_size, black, halign="center")
        elif k == int(ControlKind.SLIDER):
            out = draw_ninepatch(out, atlas, ui, UITEX_SLIDER, x0, y0, w, h, 8.0 * scale)
            # thumb (Slider.c:188-192)
            t = (st.value[i] - sdd.vmin[i]) / torch.clamp_min(sdd.vmax[i] - sdd.vmin[i], 1e-9)
            hx = x0 + t * (w - np.float32(18.0 * scale)) + np.float32(4.0 * scale)
            out = draw_ninepatch(out, atlas, ui, UITEX_SLIDER_THUMB, hx, y0 + np.float32(scale), 10.0 * scale,
                                 h - np.float32(2 * scale), 4.0 * scale)
            codes = torch.cat([label, _slider_value_codes(sdd, st, i)])
            out = draw_text1(out, atlas, ui, codes, cx, cy, font_size, white, halign="center")
        elif k in (int(ControlKind.CHECKBOX), int(ControlKind.RADIO)):
            base = UITEX_CHECKBOX_UNCHECKED if k == int(ControlKind.CHECKBOX) else UITEX_RADIO_UNCHECKED
            slot = base + st.checked[i].to(torch.int32)
            box = 32.0 * scale
            out = draw_ninepatch(out, atlas, ui, slot, x0 + np.float32(2 * scale), y0 + (h - np.float32(box)) / 2,
                                 box, box, 16.0 * scale)
            col = torch.where(~st.checked[i], gray, white) if k == int(ControlKind.RADIO) else white
            out = draw_text1(out, atlas, ui, whole, x0 + np.float32(40 * scale), cy, font_size, col, halign="left")
        elif k == int(ControlKind.TEXTBOX):
            out = draw_ninepatch(out, atlas, ui, UITEX_TEXTBOX, x0, y0, w, h, 8.0 * scale)
            empty = (st.text[i] < 0).all()
            codes = torch.where(empty, sdd.placeholder[i], st.text[i])
            col = torch.where(empty, faint, black)
            out = draw_text1(out, atlas, ui, codes, x0 + np.float32(6 * scale), cy, font_size, col, halign="left")

        # focus ring (UiStack.c:266-273), drawn over the whole frame and
        # kept where this control is the focused one
        s4, s8 = np.float32(4 * scale), np.float32(8 * scale)
        ring = draw_ninepatch(out, atlas, ui, UITEX_FOCUS_RECT, x0 - s4, y0 - s4, w + s8, h + s8, 16.0 * scale)
        out = torch.where(st.focused == i, ring, out)
    return out
