"""Multi-resolution simulation lifecycle manager.

API parity with reference xlb/helper/simulation_manager.py:16-245: owns the
per-level fields, precomputes per-level omegas via acoustic scaling, exposes
``step()`` (one coarsest-level step) and ``export_macroscopic``.
"""

import jax
import jax.numpy as jnp
import numpy as np

from xlb_tpu.models.multires import MultiresIncompressibleNavierStokesStepper, compute_omega
from xlb_tpu.ops.macroscopic import Macroscopic


class MultiresSimulationManager:
    def __init__(self, grid, omega_finest, boundary_conditions=None, collision_type="BGK", initializer=None, mres_perf_opt=None, mesh=None, mesh_axes=("x", "y")):
        self.grid = grid
        self.omega = float(omega_finest)
        self.stepper = MultiresIncompressibleNavierStokesStepper(
            grid, boundary_conditions=boundary_conditions, collision_type=collision_type,
            mres_perf_opt=mres_perf_opt,
        )
        self.f_0, self.f_1, self.bc_mask, self.missing_mask = self.stepper.prepare_fields()
        if mesh is not None:
            # shard every level over the mesh's (x, y) axes; GSPMD
            # partitions the jnp tier from these input shardings
            from jax.sharding import NamedSharding, PartitionSpec as P

            spec_axes = (None,) + tuple(mesh_axes[: grid.dim - 1]) + (None,) * max(grid.dim - 2, 0)
            spec = NamedSharding(mesh, P(*spec_axes))
            put = lambda arrs: [jax.device_put(a, spec) for a in arrs]
            self.f_0, self.f_1 = put(self.f_0), put(self.f_1)
            self.bc_mask, self.missing_mask = put(self.bc_mask), put(self.missing_mask)
        if initializer is not None:
            self.f_0 = initializer(self.f_0)
        self.iteration_idx = 0
        self._jitted = jax.jit(lambda fs: self.stepper(fs, self.bc_mask, self.missing_mask, self.omega))

    def compute_omega(self, omega_finest, level):
        return compute_omega(omega_finest, level)

    def step(self):
        """Advance one coarsest-level timestep (2^(L-1) finest steps)."""
        self.f_0 = self._jitted(self.f_0)
        self.iteration_idx += 1
        return self.f_0

    def run(self, num_coarse_steps, window=None):
        """Advance ``num_coarse_steps``; steps are grouped into jitted
        ``lax.fori_loop`` windows (one device dispatch per window)."""
        window = num_coarse_steps if window is None else min(window, num_coarse_steps)
        if getattr(self, "_window_n", None) != window:
            self._window_n = window
            self._jitted_window = self.stepper.build_window(window, donate=False)
        done = 0
        while done + window <= num_coarse_steps:
            self.f_0 = self._jitted_window(self.f_0, self.bc_mask, self.missing_mask, self.omega)
            self.iteration_idx += window
            done += window
        for _ in range(num_coarse_steps - done):
            self.step()
        return self.f_0

    def step_with_force(self, momentum_transfer):
        """Advance one coarsest-level timestep and return the momentum-
        exchange force at ``momentum_transfer.level`` (in that level's
        lattice units).  Reference capability: MultiresMomentumTransfer
        (force/multires_momentum_transfer.py:17-139)."""
        if getattr(self, "_force_mt", None) is not momentum_transfer:
            self._force_mt = momentum_transfer
            self._jitted_force = jax.jit(
                lambda fs: self.stepper.step_with_force(
                    fs, self.bc_mask, self.missing_mask, self.omega, momentum_transfer
                )
            )
        self.f_0, force = self._jitted_force(self.f_0)
        self.iteration_idx += 1
        return force

    def export_macroscopic(self):
        """Per-level (rho, u) as NumPy arrays, finest first."""
        mac = Macroscopic()
        out = []
        for f in self.f_0:
            rho, u = mac(f.astype(jnp.float32))
            out.append((np.asarray(rho), np.asarray(u)))
        return out
