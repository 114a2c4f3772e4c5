"""Diffusion noise schedules and DDIM sub-schedule tables, host-side numpy
(the port's own copy of ``leftrefill_tpu/diffusion/schedules.py``; the port
imports nothing of the JAX package).

Everything is computed in float64 numpy, as the reference does, and frozen
into float32 tables.  ``ddim_tables`` keeps the upstream behaviour that the
step count should divide 1000: the uniform sub-schedule is
``range(0, 1000, 1000 // steps) + 1``, which has more than ``steps`` entries
when it does not divide.  ``tests/test_torch_isolation.py`` holds the copy
equal to the JAX package's module.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np


def make_beta_schedule(schedule: str, n_timestep: int, linear_start: float = 1e-4,
                       linear_end: float = 2e-2, cosine_s: float = 8e-3) -> np.ndarray:
    """Beta schedule, float64.  ``linear`` (SD2's) squares a linspace between
    the square roots of the endpoints."""
    if schedule == "linear":
        return np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64) ** 2
    if schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        return np.clip(1 - alphas[1:] / alphas[:-1], 0, 0.999)
    if schedule == "sqrt_linear":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    if schedule == "sqrt":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    raise ValueError(f"schedule '{schedule}' unknown.")


def make_ddim_timesteps(ddim_discr_method: str, num_ddim_timesteps: int, num_ddpm_timesteps: int) -> np.ndarray:
    """DDIM timestep subset with the reference's +1 offset."""
    if ddim_discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ddim_timesteps = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    elif ddim_discr_method == "quad":
        ddim_timesteps = (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8), num_ddim_timesteps) ** 2).astype(int)
    else:
        raise NotImplementedError(f'There is no ddim discretization method called "{ddim_discr_method}"')
    return ddim_timesteps + 1


def make_ddim_sampling_parameters(alphacums: np.ndarray, ddim_timesteps: np.ndarray, eta: float):
    """Per-DDIM-step (sigma, alpha, alpha_prev), arXiv 2010.02502."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray([alphacums[0]] + alphacums[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


def eps_from_z_and_v(z, v, sqrt_alpha, sqrt_one_minus_alpha):
    """eps of a v prediction at the latent z_t, where alpha_t = sqrt_alpha**2
    (torch tensors or numpy arrays)."""
    return sqrt_alpha * v + sqrt_one_minus_alpha * z


def start_from_z_and_v(z, v, sqrt_alpha, sqrt_one_minus_alpha):
    """x0 of a v prediction at the latent z_t (as :func:`eps_from_z_and_v`)."""
    return sqrt_alpha * z - sqrt_one_minus_alpha * v


@dataclasses.dataclass(frozen=True)
class DDIMTables:
    """Per-step DDIM tables in ascending timestep order (the samplers walk
    them in reverse)."""

    timesteps: np.ndarray
    alphas: np.ndarray
    alphas_prev: np.ndarray
    sqrt_one_minus_alphas: np.ndarray
    sigmas: np.ndarray
    eta: float

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """The DDPM schedule buffers (float32 numpy, built in float64)."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    lvlb_weights: np.ndarray
    num_timesteps: int
    linear_start: float
    linear_end: float
    parameterization: str
    v_posterior: float

    @classmethod
    def create(cls, timesteps: int = 1000, beta_schedule: str = "linear", linear_start: float = 1e-4,
               linear_end: float = 2e-2, cosine_s: float = 8e-3, given_betas: np.ndarray | None = None,
               v_posterior: float = 0.0, parameterization: str = "eps") -> "DiffusionSchedule":
        if given_betas is not None:
            betas = np.asarray(given_betas, dtype=np.float64)
        else:
            betas = make_beta_schedule(beta_schedule, timesteps, linear_start=linear_start,
                                       linear_end=linear_end, cosine_s=cosine_s)
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        posterior_variance = ((1 - v_posterior) * betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
                              + v_posterior * betas)
        # posterior_variance[0] == 0: entry 0 of the eps weights divides by
        # zero, and the reference copies entry 1 over it
        if parameterization == "eps":
            with np.errstate(divide="ignore", invalid="ignore"):
                lvlb_weights = betas**2 / (2 * posterior_variance * alphas * (1 - alphas_cumprod))
        elif parameterization == "x0":
            lvlb_weights = 0.5 * np.sqrt(alphas_cumprod) / (2.0 * 1 - alphas_cumprod)
        elif parameterization == "v":
            lvlb_weights = np.ones_like(betas)
        else:
            raise NotImplementedError(f"unknown parameterization {parameterization}")
        lvlb_weights = lvlb_weights.copy()
        lvlb_weights[0] = lvlb_weights[1]

        f32 = partial(np.asarray, dtype=np.float32)
        return cls(
            betas=f32(betas),
            alphas_cumprod=f32(alphas_cumprod),
            alphas_cumprod_prev=f32(alphas_cumprod_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
            log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
            posterior_variance=f32(posterior_variance),
            posterior_log_variance_clipped=f32(np.log(np.maximum(posterior_variance, 1e-20))),
            posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
            posterior_mean_coef2=f32((1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)),
            lvlb_weights=f32(lvlb_weights),
            num_timesteps=int(betas.shape[0]),
            linear_start=float(linear_start),
            linear_end=float(linear_end),
            parameterization=parameterization,
            v_posterior=float(v_posterior),
        )

    def predicts_v(self) -> bool:
        """Whether a model trained on this schedule predicts v (else eps);
        the samplers refuse the other parameterizations."""
        if self.parameterization not in ("eps", "v"):
            raise NotImplementedError(f"sampling a {self.parameterization!r}-parameterized model")
        return self.parameterization == "v"

    def ddim_tables(self, num_steps: int, eta: float = 0.0, method: str = "uniform") -> DDIMTables:
        ts = make_ddim_timesteps(method, num_steps, self.num_timesteps)
        sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(
            self.alphas_cumprod.astype(np.float64), ts, eta)
        return DDIMTables(
            timesteps=ts.astype(np.int32),
            alphas=alphas.astype(np.float32),
            alphas_prev=alphas_prev.astype(np.float32),
            sqrt_one_minus_alphas=np.sqrt(1.0 - alphas).astype(np.float32),
            sigmas=sigmas.astype(np.float32),
            eta=float(eta),
        )
