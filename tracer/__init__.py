"""tracer — a differentiable Monte-Carlo path tracer in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the reference
Rust + wgpu/WGSL renderer (``cakarsubasi/02562_raytracer``): OBJ/MTL scene
loading, BSP-tree and LBVH acceleration structures, Möller-style triangle
intersection, Lambertian/Phong/mirror/dielectric (Fresnel + Beer-Lambert)
materials, point/directional/area-light next-event estimation, HDR environment
maps with RGBE decoding, stratified sampling, and progressive accumulation with
Russian-roulette termination:

* the per-pixel fragment-shader megaloop of the reference
  (``res/shaders/*.wgsl``) becomes a ``jax.jit`` wavefront over ray
  batches with masked material dispatch (no divergent branches);
* the CPU Rust builders (``src/data_structures/``) become vectorized
  NumPy/JAX builders plus an optional native C++ fast path;
* the progressive accumulation ping-pong texture pair
  (``src/bindings/texture.rs``) becomes a donated device-resident
  ``(accum, iteration)`` state;
* single-GPU rasterizer parallelism becomes pixel-tile sharding over a
  ``jax.sharding.Mesh`` with ``psum``/``all_gather`` collectives.
"""

__version__ = "0.1.0"

import os as _os

# Default persistent compilation cache: one fixed directory inside the
# checkout (gitignored). JAX itself reads JAX_COMPILATION_CACHE_DIR when it
# is set, and then no other path is configured here.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    import jax as _jax

    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)


def __getattr__(name):
    # Lazy top-level re-exports so light submodule imports stay cheap.
    if name in ("get_scenes", "get_scene"):
        import tracer.scenes as _scenes

        return getattr(_scenes, name)
    if name == "Camera":
        from tracer.render.camera import Camera

        return Camera
    raise AttributeError(name)
