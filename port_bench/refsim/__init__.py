"""The benchmark's plain reference of the simulator: a frozen copy of the
port's eager tick (core/step.py::step_batch), its reset and its eager
frame batch (render/raster.py::render_batch_eager), as they stood when
the benchmark was written, with each hand kernel replaced by the plain
PyTorch version of the same computation that the port keeps beside it.

What differs from the port: no CUDA kernel, graph capture or device
count; the gates (core/gates.py) are host `if`s; modules and functions
the tick and the frame batch do not reach are left out. It imports
nothing of the port, so a change to the port cannot move it.

It is a snapshot of the port, not an independent model: it was held to
the JAX package only through the port's own tests (tests/test_torch_*.py),
and it keeps every departure the port had from the JAX package then: the
pair warm cache keyed per env (ROADMAP.md §3 i), the rounding splits of
§3 o and p, and the upstream faults the port copies for parity (§3 e, f,
g, m, r). A comparison against it finds where the port's timed path
leaves this eager path (a graph against its eager call, a kernel against
its plain version, a later change to either), not a fault both share.
"""
