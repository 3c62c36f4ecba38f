"""The program's entry points that a traffic mix drives, one module an
engine (``ptbench/engines/<engine>.py``, named by the mix's ``engine``).

Each module has ``Engine(system, traffic, seed)`` with ``spp`` (samples a
pass), ``warm()`` (one untimed pass at the cell's own shapes from sample
0), ``window_pass()`` (the next pass of the measured window, accumulated
into the framebuffer; returns its counts), ``side_pass(first_sample)`` (one
pass of ``side_spp`` samples outside the window, not accumulated, the same
work for the same first sample: for the traced and the replayed passes), ``framebuffer()`` (the
window's radiance sums, ``(F * H * W, 3)`` over the configuration's ``F``
frames, id ``f * W * H + y * W + x``, row 0 at the top; one frame: ``y * W +
x``) and ``samples()`` (the window's first and end sample index).

``system.cameras`` holds every frame's camera and ``system.camera`` the
first. In a multi-rank cell every rank builds its engine and makes the same
calls in the same order (a pass may hold collectives); each rank's
``framebuffer()`` holds every frame, and rank 0's is checked.
``frames_pool`` renders the frames over the ranks; a pass of it renders
samples ``[0, spp)`` anew, so its framebuffer is the last pass's.
"""
