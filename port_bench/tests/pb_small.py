"""Cells of BENCHMARK.json cut to a size a test can hold: few envs, short
episodes, small frames, few samples."""

import dataclasses

from harness.spec import load_cell


def small_cell(name, envs=8, ticks=6, frame=(64, 128)):
    cell = load_cell(name)
    config = dict(cell.config, trace_calls=2, trace_ticks=3)
    if "frame" in config:
        config["frame"] = dict(config["frame"], height=frame[0], width=frame[1])
    return dataclasses.replace(
        cell, config=config, traffic=dict(cell.traffic, envs=envs, episode_ticks=ticks, episodes=2),
        checks=dict(cell.checks, sample_calls=2, stream_ticks=3))
