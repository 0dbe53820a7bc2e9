from c_game_engine_tpu_torch.audio.bank import (  # noqa: F401
    MIX_RATE,
    SAMPLES_PER_TICK,
    SoundBank,
    build_map_sound_bank,
    build_sound_bank,
)
from c_game_engine_tpu_torch.audio.mixer import (  # noqa: F401
    NUM_CHANNELS,
    AudioState,
    alloc_channels,
    empty_audio,
    listener_from_state,
    mix_frame,
    set_paused,
    stop_channels,
    tick_advance,
)
