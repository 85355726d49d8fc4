"""In-situ rendered 3D flow past a sphere.

Counterpart of the reference's PhantomGaze showcase (reference
README.md:121,137: "in-situ on GPU rendering ... no I/O" of a Q-criterion
surface over an airfoil): the whole visualization pipeline — macroscopic
velocity, Q-criterion, gradient-shaded isosurface colored by velocity
magnitude, plus a vorticity volume pass — runs on the accelerator inside
one jitted function per frame.  Only the final (H, W, 3) images cross the
device boundary; the populations never do.
"""

import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[2]))  # allow running as a script


import argparse

import numpy as np

import jax
import jax.numpy as jnp

import xlb_tpu as xlb
from xlb_tpu.velocity_set import D3Q19
from xlb_tpu.grid import grid_factory
from xlb_tpu.models import IncompressibleNavierStokesStepper
from xlb_tpu.boundary import RegularizedBC, ExtrapolationOutflowBC, HalfwayBounceBackBC
from xlb_tpu.geometry import sphere_triangles
from xlb_tpu.ops import Macroscopic
from xlb_tpu.ops.postprocess import q_criterion, vorticity_magnitude
from xlb_tpu.utils import omega_from_reynolds
from xlb_tpu.utils.render import render_isosurface, render_volume, save_render


def run(nx=128, nyz=64, re=300.0, u_in=0.05, num_steps=2000, frames=4, image=384, outdir=".", save=True):
    xlb.init(velocity_set=D3Q19(), default_backend=xlb.ComputeBackend.JAX,
             default_precision_policy=xlb.PrecisionPolicy.FP32FP32)
    grid = grid_factory((nx, nyz, nyz))
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)

    sphere_r = nyz // 8
    sphere = sphere_triangles(center=(nx / 4, nyz / 2, nyz / 2), radius=sphere_r, subdivisions=3)
    walls = np.unique(
        np.concatenate([np.asarray(box[k]) for k in ("bottom", "top", "front", "back")], axis=1), axis=1
    )
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=[
        HalfwayBounceBackBC(indices=walls.tolist()),
        RegularizedBC("velocity", prescribed_value=(u_in, 0.0, 0.0), indices=box_ne["left"]),
        ExtrapolationOutflowBC(indices=box_ne["right"]),
        HalfwayBounceBackBC(mesh_vertices=sphere),
    ])
    f_0, f_1, bc_mask, missing_mask = stepper.prepare_fields()
    omega = omega_from_reynolds(re, u_in, 2 * sphere_r)
    macro = Macroscopic()

    @jax.jit
    def render_frame(f):
        """populations -> two images, entirely on device."""
        _, u = macro(f)
        q = q_criterion(u)
        umag = jnp.linalg.norm(u, axis=0)
        surf = render_isosurface(
            q, iso=1e-6, azimuth=25, elevation=20, image_size=(image, image),
            color_by=umag, color_range=(0.0, 1.5 * u_in), cmap="viridis",
        )
        vol = render_volume(
            vorticity_magnitude(u), azimuth=25, elevation=20, image_size=(image, image),
            value_range=(0.0, 0.4 * u_in), opacity=16.0,
        )
        return surf, vol

    steps_per_frame = max(num_steps // frames, 1)
    window = stepper.build_multi_step(steps_per_frame, donate=False)
    for k in range(frames):
        f_0, f_1 = window(f_0, f_1, bc_mask, missing_mask, omega)
        surf, vol = render_frame(f_0)
        surf_np, vol_np = np.asarray(surf), np.asarray(vol)
        print(
            f"frame {k}: step {(k + 1) * steps_per_frame}, "
            f"surface px lit {(~np.all(np.isclose(surf_np, 1.0), axis=-1)).mean():.3f}, "
            f"volume max {vol_np.max():.3f}"
        )
        if save:
            save_render(surf_np, f"{outdir}/qcrit_{k:03d}.png")
            save_render(vol_np, f"{outdir}/vorticity_{k:03d}.png")
    return surf_np, vol_np


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=128)
    p.add_argument("--nyz", type=int, default=64)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--image", type=int, default=384)
    p.add_argument("--outdir", default=".")
    args = p.parse_args()
    run(nx=args.nx, nyz=args.nyz, num_steps=args.steps, frames=args.frames,
        image=args.image, outdir=args.outdir)
