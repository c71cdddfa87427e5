"""Flow-matching UniPC multistep scheduler and the device-side sampling loop.

Port of ``vitok_tpu/unipc.py``. The host scheduler
(:class:`FlowUniPCMultistepScheduler`) is numpy-only array math with host
control flow and is kept here as the port's own copy: the UniPC
predictor-corrector multistep ODE solver (UniP/UniC, bh1/bh2 B(h) variants)
specialised to rectified flow (``x_sigma = (1 - sigma) x0 + sigma eps``; the
model predicts the velocity ``eps - x0``; ``alpha_t = 1 - sigma_t``). Its
``step`` takes numpy arrays or tensors.

:func:`precompute_unipc_coefficients` extracts each step's linear
coefficients by probing that host implementation (it stays the only source of
the coefficients), and :func:`sample_flow_unipc_device` runs the whole loop on
tensors: the coefficients live on the device and nothing is read back between
steps.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import List, Optional, Tuple, Union

import numpy as np

Array = Union[np.ndarray, "object"]


@dataclasses.dataclass
class SchedulerOutput:
    prev_sample: Array


class FlowUniPCMultistepScheduler:
    """UniPC multistep sampler for flow-matching models."""

    def __init__(
        self,
        num_train_timesteps: int = 1000,
        solver_order: int = 2,
        prediction_type: str = "flow_prediction",
        shift: float = 1.0,
        use_dynamic_shifting: bool = False,
        solver_type: str = "bh2",
        lower_order_final: bool = True,
        disable_corrector: Optional[List[int]] = None,
    ):
        if prediction_type != "flow_prediction":
            raise ValueError(
                f"Only flow_prediction is supported, got {prediction_type}"
            )
        if solver_type not in ("bh1", "bh2"):
            raise ValueError(f"solver_type must be bh1|bh2, got {solver_type}")
        self.config = SimpleNamespace(
            num_train_timesteps=num_train_timesteps,
            solver_order=solver_order,
            prediction_type=prediction_type,
            shift=shift,
            use_dynamic_shifting=use_dynamic_shifting,
            solver_type=solver_type,
            lower_order_final=lower_order_final,
        )
        self.disable_corrector = disable_corrector or []
        self.sigma_max = 1.0
        self.sigma_min = 1.0 / num_train_timesteps
        self.num_inference_steps: Optional[int] = None
        self.timesteps: Optional[np.ndarray] = None
        self.sigmas: Optional[np.ndarray] = None
        self._reset_state()

    # -- schedule ---------------------------------------------------------

    def _reset_state(self):
        order = self.config.solver_order
        self.model_outputs: List[Optional[Array]] = [None] * order
        self.timestep_list: List[Optional[float]] = [None] * order
        self.lower_order_nums = 0
        self.this_order = 1
        self.last_sample: Optional[Array] = None
        self.step_index: Optional[int] = None

    @staticmethod
    def time_shift(mu: float, sigma: float, t):
        """Dynamic shifting: ``exp(mu) / (exp(mu) + (1/t - 1)^sigma)``."""
        t = np.asarray(t, np.float64)
        return np.exp(mu) / (np.exp(mu) + (1.0 / t - 1.0) ** sigma)

    def set_timesteps(
        self,
        num_inference_steps: int,
        mu: Optional[float] = None,
        shift: Optional[float] = None,
    ) -> None:
        sigmas = np.linspace(
            self.sigma_max, self.sigma_min, num_inference_steps + 1
        ).astype(np.float64)[:-1]
        if self.config.use_dynamic_shifting:
            sigmas = self.time_shift(0.0 if mu is None else mu, 1.0, sigmas)
        else:
            s = self.config.shift if shift is None else shift
            sigmas = s * sigmas / (1.0 + (s - 1.0) * sigmas)
        self.num_inference_steps = num_inference_steps
        self.timesteps = (sigmas * self.config.num_train_timesteps).astype(
            np.float32
        )
        self.sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        self._reset_state()

    # -- helpers ----------------------------------------------------------

    def scale_model_input(self, sample, timestep=None):
        return sample

    @staticmethod
    def _alpha_sigma(sigma: float) -> Tuple[float, float]:
        return 1.0 - sigma, sigma

    def _lambda(self, sigma: float) -> float:
        alpha, sig = self._alpha_sigma(sigma)
        return float(np.log(max(alpha, 1e-12)) - np.log(max(sig, 1e-12)))

    def _index_for_timestep(self, timestep) -> int:
        t = float(np.asarray(timestep))
        return int(np.argmin(np.abs(self.timesteps - t)))

    def _to_x0(self, model_output, sample, sigma: float):
        """flow_prediction: model predicts velocity eps - x0; x0 = x - sigma*v."""
        return sample - sigma * model_output

    def add_noise(self, original_samples, noise, timesteps):
        """Forward interpolation ``x = (1 - sigma) x0 + sigma eps``."""
        ts = np.asarray(timesteps, np.float32).reshape(-1)
        sig = np.array(
            [self.sigmas[self._index_for_timestep(t)] for t in ts], np.float32
        )
        shape = (-1,) + (1,) * (np.ndim(original_samples) - 1)
        sig = sig.reshape(shape)
        return (1.0 - sig) * original_samples + sig * noise

    # -- UniPC bh coefficients -------------------------------------------

    def _bh_terms(self, h: float, order: int):
        """Returns (R [order x order], b [order], h_phi_1, B_h) of the UniPC
        bh update (predict-x0 form; hh = -h)."""
        hh = -h
        h_phi_1 = float(np.expm1(hh))
        h_phi_k = h_phi_1 / hh - 1.0
        b_h = hh if self.config.solver_type == "bh1" else float(np.expm1(hh))
        rows, b = [], []
        factorial_i = 1.0
        self._rks_cache = rks = np.array(self._rks)
        for i in range(1, order + 1):
            rows.append(rks ** (i - 1))
            b.append(h_phi_k * factorial_i / b_h)
            factorial_i *= i + 1
            h_phi_k = h_phi_k / hh - 1.0 / factorial_i
        return np.stack(rows), np.array(b), h_phi_1, b_h

    def _history_terms(self, s0_index: int, lambda_s0: float, h: float, order: int):
        """rks (normalized) and D1s from history; m0 = model_outputs[-1]."""
        m0 = self.model_outputs[-1]
        rks, d1s = [], []
        for i in range(1, order):
            si = s0_index - i
            mi = self.model_outputs[-(i + 1)]
            lambda_si = self._lambda(float(self.sigmas[si]))
            rk = (lambda_si - lambda_s0) / h
            rks.append(rk)
            d1s.append((mi - m0) / rk)
        rks.append(1.0)
        self._rks = rks
        return m0, d1s

    # -- UniP (predictor) -------------------------------------------------

    def _uni_p_update(self, sample, order: int):
        step_index = self.step_index
        sigma_t = float(self.sigmas[step_index + 1])
        sigma_s0 = float(self.sigmas[step_index])
        alpha_t, sig_t = self._alpha_sigma(sigma_t)
        _, sig_s0 = self._alpha_sigma(sigma_s0)
        lambda_t = self._lambda(sigma_t)
        lambda_s0 = self._lambda(sigma_s0)
        h = lambda_t - lambda_s0

        m0, d1s = self._history_terms(step_index, lambda_s0, h, order)
        big_r, b, h_phi_1, b_h = self._bh_terms(h, order)

        x_t_ = (sig_t / max(sig_s0, 1e-12)) * sample - alpha_t * h_phi_1 * m0
        if d1s:
            if order == 2:
                rhos_p = np.array([0.5])
            else:
                rhos_p = np.linalg.solve(big_r[:-1, :-1], b[:-1])
            pred_res = sum(float(r) * d for r, d in zip(rhos_p, d1s))
            return x_t_ - alpha_t * b_h * pred_res
        return x_t_

    # -- UniC (corrector) -------------------------------------------------

    def _uni_c_update(self, this_x0, last_sample, this_sample, order: int):
        step_index = self.step_index
        sigma_t = float(self.sigmas[step_index])
        sigma_s0 = float(self.sigmas[step_index - 1])
        alpha_t, sig_t = self._alpha_sigma(sigma_t)
        _, sig_s0 = self._alpha_sigma(sigma_s0)
        lambda_t = self._lambda(sigma_t)
        lambda_s0 = self._lambda(sigma_s0)
        h = lambda_t - lambda_s0

        # History anchored at the PREVIOUS step (s0 = step_index - 1).
        m0, d1s = self._history_terms(step_index - 1, lambda_s0, h, order)
        big_r, b, h_phi_1, b_h = self._bh_terms(h, order)

        if order == 1:
            rhos_c = np.array([0.5])
        else:
            rhos_c = np.linalg.solve(big_r, b)

        x_t_ = (sig_t / max(sig_s0, 1e-12)) * last_sample - alpha_t * h_phi_1 * m0
        corr = sum(float(r) * d for r, d in zip(rhos_c[:-1], d1s)) if d1s else 0.0
        d1_t = this_x0 - m0
        return x_t_ - alpha_t * b_h * (corr + float(rhos_c[-1]) * d1_t)

    # -- public step ------------------------------------------------------

    def step(self, model_output, timestep, sample, return_dict: bool = True):
        if self.timesteps is None:
            raise RuntimeError("Call set_timesteps() before step()")
        self.step_index = step_index = self._index_for_timestep(timestep)

        sigma_s0 = float(self.sigmas[step_index])
        x0_pred = self._to_x0(model_output, sample, sigma_s0)

        use_corrector = (
            step_index > 0
            and (step_index - 1) not in self.disable_corrector
            and self.last_sample is not None
            and self.model_outputs[-1] is not None
        )
        if use_corrector:
            # History keeps the PRE-correction x0 conversion (the corrector
            # refines the sample, not the stored model output — matching the
            # documented FlowUniPC algorithm).
            sample = self._uni_c_update(
                x0_pred, self.last_sample, sample, self.this_order
            )

        # Shift history.
        for i in range(self.config.solver_order - 1):
            self.model_outputs[i] = self.model_outputs[i + 1]
            self.timestep_list[i] = self.timestep_list[i + 1]
        self.model_outputs[-1] = x0_pred
        self.timestep_list[-1] = float(np.asarray(timestep))

        this_order = self.config.solver_order
        if self.config.lower_order_final:
            this_order = min(this_order, len(self.timesteps) - step_index)
        self.this_order = max(min(this_order, self.lower_order_nums + 1), 1)

        self.last_sample = sample
        prev_sample = self._uni_p_update(sample, self.this_order)

        if self.lower_order_nums < self.config.solver_order:
            self.lower_order_nums += 1

        if return_dict:
            return SchedulerOutput(prev_sample=prev_sample)
        return (prev_sample,)

    def __len__(self):
        return self.config.num_train_timesteps


# ---------------------------------------------------------------------------
# Device-side sampling: the whole UniPC loop on device tensors
# ---------------------------------------------------------------------------


def _simulate_order_schedule(config, steps: int, disable_corrector):
    """Replicate ``step()``'s order bookkeeping: per-step
    ``(use_corrector, corrector_order, predictor_order)``.

    The corrector at step ``i`` uses ``this_order`` as computed at step
    ``i-1`` (the host stores it on ``self``); the predictor uses the value
    recomputed after the history shift — this mirrors that sequence exactly.
    """
    lower_order_nums = 0
    this_order = 1
    plan = []
    for i in range(steps):
        use_c = i > 0 and (i - 1) not in disable_corrector
        o_c = this_order
        to = config.solver_order
        if config.lower_order_final:
            to = min(to, steps - i)
        to = max(min(to, lower_order_nums + 1), 1)
        o_p = this_order = to
        if lower_order_nums < config.solver_order:
            lower_order_nums += 1
        plan.append((use_c, o_c, o_p))
    return plan


def precompute_unipc_coefficients(
    scheduler: "FlowUniPCMultistepScheduler",
    num_inference_steps: int,
    mu: Optional[float] = None,
    shift: Optional[float] = None,
):
    """Per-step linear coefficients of the UniPC update, extracted by unit
    probing of the HOST implementation.

    Every UniP/UniC update is a linear combination of (sample, last_sample,
    current x0 prediction, x0 history) with scalars that depend only on the
    sigma schedule and solver order — never on the data. Probing
    ``_uni_p_update`` / ``_uni_c_update`` with unit scalars therefore
    recovers the exact per-step coefficient rows, with the host code as the
    single source of truth (no re-derived formulas to drift). A fresh
    scheduler instance is probed; the caller's is untouched.

    ``mu`` / ``shift`` forward to ``set_timesteps`` so dynamic-shifting /
    shift-override schedules probe the same sigma schedule the host loop
    runs (passing neither reproduces ``set_timesteps(S)``).

    Returns a dict of numpy arrays over ``S = num_inference_steps`` steps:
    ``sigmas [S]``, ``timesteps [S]``, ``use_corrector [S]``,
    ``cc [S, 4]`` (corrector coeffs on last_sample / x0_{i-1} / x0_{i-2} /
    x0_i) and ``cp [S, 3]`` (predictor coeffs on corrected sample / x0_i /
    x0_{i-1}). Supports ``solver_order <= 2`` (the documented config).
    """
    if scheduler.config.solver_order > 2:
        raise NotImplementedError(
            "device-loop coefficient extraction supports solver_order <= 2"
        )
    sched = FlowUniPCMultistepScheduler(
        num_train_timesteps=scheduler.config.num_train_timesteps,
        solver_order=scheduler.config.solver_order,
        shift=scheduler.config.shift,
        use_dynamic_shifting=scheduler.config.use_dynamic_shifting,
        solver_type=scheduler.config.solver_type,
        lower_order_final=scheduler.config.lower_order_final,
        disable_corrector=list(scheduler.disable_corrector),
    )
    sched.set_timesteps(num_inference_steps, mu=mu, shift=shift)
    S = num_inference_steps
    plan = _simulate_order_schedule(sched.config, S, sched.disable_corrector)

    cc = np.zeros((S, 4), np.float64)
    cp = np.zeros((S, 3), np.float64)
    use_c = np.zeros((S,), bool)

    def outputs(m0, m1):
        # model_outputs[-1] = m0, [-2] = m1 (length = solver_order).
        if sched.config.solver_order == 1:
            return [m0]
        return [m1, m0]

    for i, (uc, o_c, o_p) in enumerate(plan):
        if uc:
            use_c[i] = True
            sched.step_index = i

            def probe_c(last, m0, m1, cur):
                sched.model_outputs = outputs(float(m0), float(m1))
                return float(
                    sched._uni_c_update(float(cur), float(last), 0.0, o_c)
                )

            assert probe_c(0, 0, 0, 0) == 0.0, "corrector not homogeneous"
            for j, pr in enumerate(np.eye(4)):
                cc[i, j] = probe_c(*pr)
        sched.step_index = i

        def probe_p(z, m0, m1):
            sched.model_outputs = outputs(float(m0), float(m1))
            return float(sched._uni_p_update(float(z), o_p))

        assert probe_p(0, 0, 0) == 0.0, "predictor not homogeneous"
        for j, pr in enumerate(np.eye(3)):
            cp[i, j] = probe_p(*pr)

    return {
        "sigmas": np.asarray(sched.sigmas[:S], np.float32),
        "timesteps": np.asarray(sched.timesteps, np.float32),
        "use_corrector": use_c,
        "cc": cc.astype(np.float32),
        "cp": cp.astype(np.float32),
    }


def sample_flow_unipc_device(
    model_v_fn,
    z0,
    scheduler: Optional["FlowUniPCMultistepScheduler"] = None,
    steps: int = 20,
    coefficients=None,
    mu: Optional[float] = None,
    shift: Optional[float] = None,
):
    """The whole UniPC sampling loop on the device of ``z0`` (a tensor).

    Counterpart of the host loop in ``scripts/generate.py``: the per-step
    coefficients (:func:`precompute_unipc_coefficients`) are device tensors
    and each step is tensor arithmetic, so the host only enqueues work: no
    ``.item()``, no numpy round trip, no synchronisation between steps.
    ``model_v_fn(z, t) -> velocity`` gets the latents and the step's timestep
    as a 0-d tensor (put CFG batch doubling inside it).

    Returns the final latents (same shape and dtype as ``z0``).
    """
    import torch

    if coefficients is None:
        if scheduler is None:
            scheduler = FlowUniPCMultistepScheduler(shift=1.0)
        coefficients = precompute_unipc_coefficients(scheduler, steps, mu=mu, shift=shift)
    dev = z0.device
    sig = torch.as_tensor(coefficients["sigmas"], device=dev)
    ts = torch.as_tensor(coefficients["timesteps"], device=dev)
    cc = torch.as_tensor(coefficients["cc"], device=dev)
    cp = torch.as_tensor(coefficients["cp"], device=dev)
    # Which steps run the corrector is known on the host before the loop.
    use_c = [bool(u) for u in np.asarray(coefficients["use_corrector"])]

    z = z0
    last_z = x0p = x0p2 = torch.zeros_like(z0)
    for i in range(int(sig.shape[0])):
        v = model_v_fn(z, ts[i])
        x0c = z - sig[i] * v.to(z.dtype)
        zc = z
        if use_c[i]:
            zc = cc[i, 0] * last_z + cc[i, 1] * x0p + cc[i, 2] * x0p2 + cc[i, 3] * x0c
        z_next = cp[i, 0] * zc + cp[i, 1] * x0c + cp[i, 2] * x0p
        z, last_z, x0p, x0p2 = z_next, zc, x0c, x0p
    return z


__all__ = [
    "FlowUniPCMultistepScheduler",
    "SchedulerOutput",
    "precompute_unipc_coefficients",
    "sample_flow_unipc_device",
]
