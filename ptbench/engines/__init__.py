"""The program's entry points that a traffic mix drives, one module an
engine (``ptbench/engines/<engine>.py``, named by the mix's ``engine``).

Each module has ``Engine(system, traffic, seed)`` with ``spp`` (samples a
pass), ``warm()`` (one untimed pass at the cell's own shapes from sample
0), ``window_pass()`` (the next pass of the measured window, accumulated
into the framebuffer; returns its counts), ``side_pass(first_sample)`` (one
pass of ``side_spp`` samples outside the window, not accumulated, the same
work for the same first sample: for the traced and the replayed passes), ``framebuffer()`` (the
window's radiance sums, ``(H * W, 3)``, pixel id ``y * W + x``, row 0 at the
top) and ``samples()`` (the window's first and end sample index).
"""
