"""Scene container: traced device buffers + static render configuration.

The reference splits scene state across a static ``SceneDescriptor`` table
(``/root/reference/src/scenes.rs:20-29``), per-scene WGSL shader source, and a
runtime ``Uniform`` struct driven by the control panel
(``/root/reference/src/bindings/uniform.rs:8-34``). Here that becomes:

* ``Scene`` — a pytree of device arrays (geometry, accel, materials, lights,
  textures, camera, uniforms). Changing any value re-runs the same compiled
  step — no recompilation, the analog of writing a uniform buffer.
* ``SceneConfig`` — a frozen, hashable dataclass of *structural* choices
  (integrator mode, light kinds, traversal, feature flags). Changing one is
  the analog of swapping the WGSL shader: a new XLA compilation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import jax.numpy as jnp

from tracer.accel.lbvh import BvhBuffers
from tracer.geometry.device import (
    AnalyticTriangles,
    GeometryBuffers,
    MaterialTable,
    Planes,
    Spheres,
    empty_planes,
    empty_spheres,
    empty_triangles,
)
from tracer.render.camera import Camera
from tracer.render.texture import TextureBuf
from tracer.util import pytree_dataclass

# Sentinel shader values meaning "resolve from uniforms at trace time" —
# the reference routes the control panel's material combos through
# uniforms.selection1/selection2 (e.g. w2e2.wgsl:177-181).
FROM_SELECTION1 = -1
FROM_SELECTION2 = -2


@pytree_dataclass
class Uniforms:
    """Runtime-tunable state (mirrors ``Uniform``, uniform.rs:8-34)."""

    selection1: jnp.ndarray  # () i32 — sphere/mesh material override
    selection2: jnp.ndarray  # () i32 — other material override
    use_texture: jnp.ndarray  # () i32 — TextureUse mode
    uv_scale: jnp.ndarray  # (2,) f32
    iteration: jnp.ndarray  # () u32 — progressive frame index


def make_uniforms(
    selection1: int = 0,
    selection2: int = 0,
    use_texture: int = 0,
    uv_scale=(1.0, 1.0),
    iteration: int = 0,
) -> Uniforms:
    return Uniforms(
        selection1=jnp.asarray(selection1, jnp.int32),
        selection2=jnp.asarray(selection2, jnp.int32),
        use_texture=jnp.asarray(use_texture, jnp.int32),
        uv_scale=jnp.asarray(uv_scale, jnp.float32),
        iteration=jnp.asarray(iteration, jnp.uint32),
    )


@dataclass(frozen=True)
class SceneConfig:
    """Static (compile-time) render configuration — the WGSL-shader analog."""

    width: int = 512
    height: int = 512
    max_depth: int = 10  # bounce budget (MAX_DEPTH, 10 or 50)
    eta: float = 1.0e-5  # ray epsilon (per-shader ETA constant)
    tmax: float = 5000.0  # ray_init tmax
    bg_color: tuple = (0.1, 0.3, 0.6)  # miss color (per-scene bgcolor)
    mode: str = "direct"  # "direct" (w1-w6) | "path" (w7-w9)
    # light kinds evaluated by lambertian/phong:
    #   "point_w1"      w1e6-style point light (quirks preserved)
    #   "directional"   single directional (w5e2.wgsl:293-304)
    #   "directional_n" directional scaled by the light count (w6e1/project
    #                   loop over lightIndices with a directional sampler)
    #   "area_all"      deterministic center sample of every area light
    #                   (w5e5/w6e3)
    #   "area_mc"       random light pick + sqrt-warp sample (w7e3+ NEE)
    #   "none"          no direct lighting (w9e2's commented-out NEE)
    lights: tuple = ("point_w1",)
    point_light_pos: tuple = (0.0, 1.2, 0.0)
    point_light_intensity: tuple = (
        5.0 * 3.14159265359,
    ) * 3  # pi * I (w1e6.wgsl:240-241)
    dir_light_direction: tuple = (-1.0, -1.0, -1.0)  # w5e2.wgsl:296
    dir_light_intensity: tuple = (5.0 * 3.14159265359,) * 3
    shadows: bool = True  # trace shadow rays in direct mode (w2+)
    # ambient/diffuse combination in direct lambertian:
    #   "mix"          0.9*diffuse + 0.1*base (w1/w2, diffuse_and_ambient)
    #   "plain"        diffuse + material emission (w5e5/w6e3)
    #   "plain_scaled" diffuse + 0.1 * material emission (project.wgsl:295)
    ambient: str = "mix"
    emit_gating: bool = True  # NEE double-count avoidance (w8e3.wgsl:475-478)
    rr: bool = True  # Russian-roulette indirect bounce (off in w8e1)
    emission_factor: bool = True  # emission *= factor (w8e3/w9; off in w7e3)
    diffuse_factor: bool = True  # NEE term *= factor (off in w8e1)
    dielectric: str = "absorb"  # "simple" (w2e3) | "fresnel" (w8e2) |
    #                              "absorb" (w8e3) | "absorb_v2" (w9e2)
    beer_distance_scale: float = 100.0  # w8e3: s = |p - o| / 100
    firefly_clamp: float = 0.0  # min(shade, clamp) when > 0 (w8e3.wgsl:250)
    gamma: float = 1.0  # display transform exponent (pow(color, gamma))
    traversal: str = "bvh"  # "brute" | "bvh" | "bsp"
    # How "bsp" scenes execute. The reference's default engine for w6-w8
    # is the spliced BSP library (res/shaders/bsp.wgsl:10-81), a per-ray
    # gather walk; "fast" keeps the BSP tree as the built,
    # tested structure but serves rendering through the treelet engines —
    # closest-hit results are traversal-independent (parity-gated in
    # tests/test_oracle_parity.py). "walk" forces the faithful per-ray
    # BSP traversal (tracer.accel.bsp).
    bsp_execution: str = "fast"
    use_vertex_normals: bool = True  # interpolate vs face normal
    mesh_shader: int = 0  # shader for trimesh hits; FROM_SELECTION1 for UI
    env_light: bool = False  # miss -> environment map (vs bg color)
    plane_texture: bool = False  # textured plane albedo (w3)
    progressive: bool = False  # progressive accumulation scenes (w7+)
    subdivs: int = 1  # stratified sub-pixel grid (1..10, w3e3)
    max_leaf: int = 8  # static unroll bound for BVH leaf tests
    sphere_ior_default: float = 1.5
    # Shader ids that can occur in this scene (compile-time). Branches for
    # absent ids are not emitted — the analog of each reference scene
    # compiling only its own WGSL shade switch. Changing a material
    # selection to an id outside this set requires a rebuild (recompile).
    possible_shaders: tuple = (0, 1, 2, 3, 4, 5, 6, 7, 8)
    # Bounce-loop driver: "while" exits as soon as every lane terminated
    # (fast rendering); "scan" runs the full static depth (reverse-mode
    # differentiable — used by tracer.diff).
    loop: str = "while"
    # Rematerialization policy for the differentiable scan driver:
    # "none" saves all bounce residuals (memory-heavy, no recompute),
    # "full" recomputes each bounce in the backward (jax.checkpoint),
    # "dots" saves only contractions (checkpoint_dots policy).
    remat: str = "none"
    name: str = ""


@pytree_dataclass
class Scene:
    """All traced device state for one scene."""

    camera: Camera
    uniforms: Uniforms
    spheres: Spheres
    planes: Planes
    tris: AnalyticTriangles
    geom: Optional[GeometryBuffers]
    materials: Optional[MaterialTable]
    light_indices: Optional[jnp.ndarray]  # (L,) i32 emissive triangle ids
    bvh: Optional[BvhBuffers]
    wide: Optional[object]  # WideBvh — 8-ary BVH (accel.wide)
    tb: Optional[object]  # TreeletBvh — packet-traversal structure (accel.treelet)
    bsp: Optional[object]  # BspBuffers (imported lazily to avoid cycles)
    env: Optional[TextureBuf]
    texture: Optional[TextureBuf]  # plane texture (grass.jpg)
    jitters: Optional[jnp.ndarray]  # (subdivs^2, 2) stratified offsets


def make_scene(
    camera: Camera,
    uniforms: Optional[Uniforms] = None,
    spheres: Optional[Spheres] = None,
    planes: Optional[Planes] = None,
    tris: Optional[AnalyticTriangles] = None,
    geom: Optional[GeometryBuffers] = None,
    materials: Optional[MaterialTable] = None,
    light_indices=None,
    bvh: Optional[BvhBuffers] = None,
    wide=None,
    tb=None,
    bsp=None,
    env: Optional[TextureBuf] = None,
    texture: Optional[TextureBuf] = None,
    jitters=None,
) -> Scene:
    return Scene(
        camera=camera,
        uniforms=uniforms if uniforms is not None else make_uniforms(),
        spheres=spheres if spheres is not None else empty_spheres(),
        planes=planes if planes is not None else empty_planes(),
        tris=tris if tris is not None else empty_triangles(),
        geom=geom,
        materials=materials,
        light_indices=light_indices,
        bvh=bvh,
        wide=wide,
        tb=tb,
        bsp=bsp,
        env=env,
        texture=texture,
        jitters=jitters,
    )
