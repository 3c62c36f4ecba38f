"""The upstream renderer's Cornell box (``main.rs``'s scene; ``SURVEY.md``
section 1): five walls of two triangles each, a two-triangle area light just
under the ceiling and one rough-glass sphere.

The constants and the insertion order are those of
``pathtrace_tpu_torch.models.scenes.cornell_box`` (copied), so the program
receives the same 12 triangles and sphere from this description.
"""

from __future__ import annotations

from ptbench.scene import SceneDescription


def build(box_size: float = 1.0, box_depth: float = -2.0,
          light_size: float = 0.3) -> SceneDescription:
    s = SceneDescription()
    red = s.material("Lambertian", albedo=(0.8, 0.1, 0.1))
    green = s.material("Lambertian", albedo=(0.1, 0.8, 0.1))
    blue = s.material("Lambertian", albedo=(0.2, 0.2, 0.8))
    cyan = s.material("Lambertian", albedo=(0.2, 0.8, 0.8))
    white = s.material("Lambertian", albedo=(0.8, 0.8, 0.8))
    light = s.material("Emissive", emission=(15.0, 15.0, 15.0))
    glass = s.material("Mirror", roughness=0.3, color=(1.0, 1.0, 1.0), metallic=0.0, ior=1.5)

    b, d, ls = box_size, box_depth, light_size
    for verts, mat in (
        (((-b, -b, d - b), (-b, b, d - b), (-b, b, d + b)), red),
        (((-b, -b, d - b), (-b, b, d + b), (-b, -b, d + b)), red),
        (((b, -b, d - b), (b, b, d + b), (b, b, d - b)), green),
        (((b, -b, d - b), (b, -b, d + b), (b, b, d + b)), green),
        (((-b, -b, d - b), (b, -b, d - b), (b, b, d - b)), blue),
        (((-b, -b, d - b), (b, b, d - b), (-b, b, d - b)), blue),
        (((-b, -b, d - b), (b, -b, d + b), (b, -b, d - b)), cyan),
        (((-b, -b, d - b), (-b, -b, d + b), (b, -b, d + b)), cyan),
        (((-b, b, d - b), (b, b, d - b), (b, b, d + b)), white),
        (((-b, b, d - b), (b, b, d + b), (-b, b, d + b)), white),
        (((-ls, b - 0.01, d - ls), (ls, b - 0.01, d - ls), (ls, b - 0.01, d + ls)), light),
        (((-ls, b - 0.01, d - ls), (ls, b - 0.01, d + ls), (-ls, b - 0.01, d + ls)), light),
    ):
        s.add_mesh(verts, [[0, 1, 2]], mat)
    s.add_sphere((0.4, -0.6, d), 0.4, glass)
    return s
