"""The mixer's rate: samples a channel advances per 60 Hz tick."""

MIX_RATE = 48000  # copied from the port's audio/bank.py
SAMPLES_PER_TICK = MIX_RATE // 60
