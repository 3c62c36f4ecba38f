"""BSDF lanes of the plain reference, one module a material kind (the
module named after the kind in lower case): ``eval(m, i, o, n, eta)`` gives
``(bsdf (N, 3), pdf (N,))`` toward ``o`` and ``sample(m, i, n, eta, r1, r2,
coin)`` gives ``(direction, bsdf, pdf, cos)``. ``m`` maps each parameter of
the kind to a per-path tensor; ``i`` points to the viewer and ``n`` is the
face-forwarded normal."""
