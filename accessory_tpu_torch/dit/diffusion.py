"""Gaussian diffusion: schedules, the exact hybrid loss, respacing, samplers.

Port of ``accessory_tpu/dit/diffusion.py`` (the OpenAI ADM formulation:
linear / cosine beta schedules, learned-range / fixed variances, the hybrid
eps-MSE + VB loss rescaled by T/1000, respacing incl. "ddimN" strides, the
DDPM ancestral and DDIM samplers and the classifier-free guidance wrapper).

The schedules are computed in float64 numpy on the host, as in the
reference, rounded to f32 once and moved to a device the first time a
method meets a tensor there (``GaussianDiffusion._consts``). The samplers
are Python loops of device ops (the reference scans them under ``jit``).

Randomness: the reference draws from JAX keys; here every draw comes from
an explicit ``torch.Generator`` (on the device the draw is made on), and
each draw can be handed in instead: ``noise=`` in ``training_loss``,
``x_T=`` and ``noise=`` (the per-step draws) in the sample loops.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch


def linear_beta_schedule(T: int) -> np.ndarray:
    scale = 1000.0 / T
    betas = np.linspace(scale * 1e-4, scale * 0.02, T, dtype=np.float64)
    # at small T the 1000/T scaling reaches beta=1.0 (alpha_bar=0: a division
    # by zero downstream); clip just below
    return np.clip(betas, 0.0, 0.999)


def cosine_beta_schedule(T: int, s: float = 0.008) -> np.ndarray:
    f = np.cos((np.arange(T + 1) / T + s) / (1 + s) * np.pi / 2) ** 2
    betas = 1 - f[1:] / f[:-1]
    return np.clip(betas, 0, 0.999)


def space_timesteps(num_timesteps: int,
                    section_counts: Union[str, Sequence[int]]) -> set:
    """The timestep subset to keep (respace.space_timesteps semantics):
    "ddimN" uses the fixed DDIM stride; otherwise comma-separated section
    counts stride equally-sized portions of the original process."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            want = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == want:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(f"cannot make exactly {want} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start = 0
    out = []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot take {count} steps from a section of {size}")
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            out.append(start + round(cur))
            cur += stride
        start += size
    return set(out)


def _normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N(mean1, var1) || N(mean2, var2)) elementwise, in nats."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + torch.square(mean1 - mean2) * torch.exp(-logvar2))


def _approx_std_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * (x * x * x))))


def _discretized_gaussian_ll(x, means, log_scales):
    """log p(x) for images discretized to 256 bins in [-1, 1]
    (diffusion_utils.discretized_gaussian_log_likelihood)."""
    centered = x - means
    inv_std = torch.exp(-log_scales)
    plus = _approx_std_cdf(inv_std * (centered + 1.0 / 255.0))
    minus = _approx_std_cdf(inv_std * (centered - 1.0 / 255.0))
    log_plus = torch.log(torch.clamp_min(plus, 1e-12))
    log_1m_minus = torch.log(torch.clamp_min(1.0 - minus, 1e-12))
    log_delta = torch.log(torch.clamp_min(plus - minus, 1e-12))
    return torch.where(x < -0.999, log_plus, torch.where(x > 0.999, log_1m_minus, log_delta))


def _mean_flat(x):
    return torch.mean(x.reshape(x.shape[0], -1), dim=1)


def _per_row(v, ndim: int):
    """A (b,) per-example value shaped to broadcast over (b, ...) of ``ndim``."""
    return v.reshape((-1,) + (1,) * (ndim - 1))


def _device_of(x_T, generator, device):
    if x_T is not None:
        return x_T.device
    return generator.device if generator is not None else torch.device(device)


# the f32 tables a method reads, by name
_TABLES = ("betas", "alphas_cumprod", "sqrt_acp", "sqrt_1m_acp", "sqrt_recip_acp",
           "sqrt_recipm1_acp", "posterior_var", "posterior_logvar_clipped",
           "posterior_mean_c0", "posterior_mean_ct", "log_betas", "fixed_large_var",
           "fixed_large_logvar")


@dataclasses.dataclass
class GaussianDiffusion:
    num_timesteps: int = 1000
    schedule: str = "linear"
    learn_sigma: bool = True
    var_type: str = "learned_range"  # | "fixed_small" | "fixed_large"
    betas_override: Optional[np.ndarray] = None
    # respacing: model-facing timestep = timestep_map[t] (original indexing)
    timestep_map: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.betas_override is not None:
            betas = np.asarray(self.betas_override, np.float64)
            self.num_timesteps = len(betas)
        else:
            betas = (linear_beta_schedule(self.num_timesteps) if self.schedule == "linear"
                     else cosine_beta_schedule(self.num_timesteps))
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = betas * (1 - acp_prev) / (1 - acp)
        # FIXED_LARGE variance (gaussian_diffusion.py:298-301): beta_t with the
        # t=0 entry replaced by the posterior variance
        fl = np.append(post_var[1], betas[1:])
        host = {
            "betas": betas, "alphas_cumprod": acp, "sqrt_acp": np.sqrt(acp),
            "sqrt_1m_acp": np.sqrt(1 - acp), "sqrt_recip_acp": np.sqrt(1 / acp),
            "sqrt_recipm1_acp": np.sqrt(1 / acp - 1), "posterior_var": post_var,
            "posterior_logvar_clipped": np.log(np.append(post_var[1], post_var[1:])),
            "posterior_mean_c0": betas * np.sqrt(acp_prev) / (1 - acp),
            "posterior_mean_ct": (1 - acp_prev) * np.sqrt(alphas) / (1 - acp),
            "log_betas": np.log(betas), "fixed_large_var": fl,
            "fixed_large_logvar": np.log(fl)}
        # the f64 tables rounded to f32 once, on the host
        for name in _TABLES:
            setattr(self, name, torch.from_numpy(host[name].astype(np.float32)))
        self._tmap = (None if self.timestep_map is None
                      else torch.from_numpy(np.asarray(self.timestep_map, np.int64)))
        self._on: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def _consts(self, device) -> Dict[str, torch.Tensor]:
        """The f32 tables (and the timestep map) on ``device``, moved there once."""
        device = torch.device(device)
        if device not in self._on:
            on = {name: getattr(self, name).to(device) for name in _TABLES}
            on["tmap"] = None if self._tmap is None else self._tmap.to(device)
            on["acp_full"] = torch.cat([torch.ones(1, device=device), on["alphas_cumprod"]])
            self._on[device] = on
        return self._on[device]

    # -- respacing ---------------------------------------------------------

    def respaced(self, section_counts: Union[str, Sequence[int]]) -> "GaussianDiffusion":
        """SpacedDiffusion (respace.py): keep only the selected original
        timesteps, recompute betas so the marginals match, and record the
        original indices so the model still sees original-scale t. The
        marginals are taken from the f32 betas, as the reference does."""
        use = sorted(space_timesteps(self.num_timesteps, section_counts))
        acp = np.cumprod(1.0 - self.betas.numpy().astype(np.float64))
        last = 1.0
        new_betas, tmap = [], []
        for t in use:
            new_betas.append(1.0 - acp[t] / last)
            last = acp[t]
            tmap.append(t)
        return GaussianDiffusion(schedule=self.schedule, learn_sigma=self.learn_sigma,
                                 var_type=self.var_type, betas_override=np.asarray(new_betas),
                                 timestep_map=np.asarray(tmap))

    def _model_t(self, t):
        tmap = self._consts(t.device)["tmap"]
        return t if tmap is None else tmap[t]

    # -- forward process -------------------------------------------------

    def q_sample(self, x0, t, noise):
        c = self._consts(x0.device)
        return (_per_row(c["sqrt_acp"][t], x0.ndim) * x0
                + _per_row(c["sqrt_1m_acp"][t], x0.ndim) * noise)

    def q_posterior(self, x0, xt, t):
        c = self._consts(x0.device)
        mean = (_per_row(c["posterior_mean_c0"][t], x0.ndim) * x0
                + _per_row(c["posterior_mean_ct"][t], x0.ndim) * xt)
        return mean, _per_row(c["posterior_logvar_clipped"][t], x0.ndim)

    # -- reverse process -------------------------------------------------

    def _eps_to_x0(self, xt, t, eps):
        c = self._consts(xt.device)
        return (_per_row(c["sqrt_recip_acp"][t], xt.ndim) * xt
                - _per_row(c["sqrt_recipm1_acp"][t], xt.ndim) * eps)

    def p_mean_variance(self, model_out, xt, t, clip: bool = True):
        """model output -> (mean, logvar, pred_x0) of p(x_{t-1}|x_t)
        (gaussian_diffusion.py:254-333, mean_type=EPSILON)."""
        c = self._consts(xt.device)
        if self.learn_sigma:
            eps, var_raw = torch.chunk(model_out, 2, dim=1)
            frac = (var_raw + 1) / 2
            logvar = (frac * _per_row(c["log_betas"][t], xt.ndim)
                      + (1 - frac) * _per_row(c["posterior_logvar_clipped"][t], xt.ndim))
        else:
            eps = model_out
            table = (c["fixed_large_logvar"] if self.var_type == "fixed_large"
                     else c["posterior_logvar_clipped"])
            logvar = _per_row(table[t], xt.ndim).expand(xt.shape)
        x0 = self._eps_to_x0(xt, t, eps)
        if clip:
            x0 = torch.clamp(x0, -1, 1)
        mean, _ = self.q_posterior(x0, xt, t)
        return mean, logvar, x0

    # -- losses ------------------------------------------------------------

    def vb_term(self, model_out, x0, xt, t, clip: bool = False):
        """Per-example VB term in bits/dim: KL(q(x_{t-1}|x_t,x_0) ||
        p(x_{t-1}|x_t)) for t>0, discretized gaussian NLL at t=0
        (gaussian_diffusion.py:683-715)."""
        true_mean, true_logvar = self.q_posterior(x0, xt, t)
        mean, logvar, _ = self.p_mean_variance(model_out, xt, t, clip=clip)
        kl = _mean_flat(_normal_kl(true_mean, true_logvar.expand(xt.shape), mean,
                                   logvar)) / math.log(2.0)
        nll = -_mean_flat(_discretized_gaussian_ll(x0, mean, 0.5 * logvar)) / math.log(2.0)
        return torch.where(t == 0, nll, kl)

    def training_loss(self, model_fn: Callable, x0, t, generator=None, model_args=(),
                      reduce: bool = True, noise=None):
        """Exact hybrid loss (LossType.RESCALED_MSE + LEARNED_RANGE,
        gaussian_diffusion.py:747-771): per-example eps-MSE plus the true
        VB term with the mean frozen (eps detached inside the VB input),
        rescaled by T/1000. ``noise``: the draw to use (else drawn from
        ``generator`` on x0's device).

        ``reduce=False`` returns the per-example (b,) loss vector instead of
        the batch mean (the loss-aware timestep sampler needs the per-(t,
        loss) pairs and applies its importance weights before reducing)."""
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, dtype=x0.dtype,
                                device=x0.device)
        xt = self.q_sample(x0, t, noise)
        out = model_fn(xt, self._model_t(t), *model_args)
        if self.learn_sigma:
            eps, var_raw = torch.chunk(out, 2, dim=1)
            mse_per = _mean_flat(torch.square(eps - noise))
            # freeze the mean for the VB term so it only trains the variance
            frozen = torch.cat([eps.detach(), var_raw], dim=1)
            vb_per = self.vb_term(frozen, x0, xt, t) * (self.num_timesteps / 1000.0)
            per = mse_per + vb_per
            parts = {"mse": torch.mean(mse_per), "vb": torch.mean(vb_per)}
        else:
            per = _mean_flat(torch.square(out - noise))
            parts = {"mse": torch.mean(per), "vb": torch.zeros((), device=x0.device)}
        return (torch.mean(per) if reduce else per), parts

    # -- sampling ----------------------------------------------------------

    @torch.no_grad()
    def p_sample_loop(self, model_fn: Callable, shape, generator=None, model_args=(),
                      clip: bool = True, *, x_T=None, noise=None, device="cuda"):
        """DDPM ancestral sampling. ``x_T``: the starting noise, ``noise``:
        one draw a step in loop order (t = T-1 down to 0); what is not
        handed in is drawn from ``generator``, x_T first."""
        device = _device_of(x_T, generator, device)
        x = x_T if x_T is not None else torch.randn(shape, generator=generator,
                                                    device=device)
        for i, t in enumerate(range(self.num_timesteps - 1, -1, -1)):
            tb = torch.full((shape[0],), t, dtype=torch.long, device=device)
            out = model_fn(x, self._model_t(tb), *model_args)
            mean, logvar, _ = self.p_mean_variance(out, x, tb, clip=clip)
            z = noise[i] if noise is not None else torch.randn(shape, generator=generator,
                                                                device=device)
            x = mean + float(t > 0) * torch.exp(0.5 * logvar) * z
        return x

    @torch.no_grad()
    def ddim_sample_loop(self, model_fn: Callable, shape, generator=None,
                         steps: Optional[int] = None, eta: float = 0.0, clip: bool = True,
                         model_args=(), *, x_T=None, noise=None, device="cuda"):
        """DDIM over a strided subsequence (or this (respaced) process's own
        timesteps when steps is None). ``x_T`` / ``noise`` as in
        ``p_sample_loop``; at ``eta`` 0 the step adds no noise and none is
        drawn."""
        device = _device_of(x_T, generator, device)
        x = x_T if x_T is not None else torch.randn(shape, generator=generator,
                                                    device=device)
        if steps is None or steps >= self.num_timesteps:
            seq = np.arange(self.num_timesteps - 1, -1, -1)
        else:
            seq = np.linspace(0, self.num_timesteps - 1, steps, dtype=np.int64)[::-1].copy()
        seq_prev = np.append(seq[1:], -1)
        c = self._consts(device)
        acp_full = c["acp_full"]
        for i, (t, t_prev) in enumerate(zip(seq.tolist(), seq_prev.tolist())):
            tb = torch.full((shape[0],), t, dtype=torch.long, device=device)
            out = model_fn(x, self._model_t(tb), *model_args)
            eps = torch.chunk(out, 2, dim=1)[0] if self.learn_sigma else out
            x0 = self._eps_to_x0(x, tb, eps)
            if clip:
                x0 = torch.clamp(x0, -1, 1)
            # re-derive eps from the (possibly clipped) x0 (gaussian_
            # diffusion.py:514-560 does the same)
            eps = ((_per_row(c["sqrt_recip_acp"][tb], x.ndim) * x - x0)
                   / _per_row(c["sqrt_recipm1_acp"][tb], x.ndim))
            a_t, a_prev = acp_full[t + 1], acp_full[t_prev + 1]
            sigma = eta * torch.sqrt((1 - a_prev) / (1 - a_t)) * torch.sqrt(1 - a_t / a_prev)
            dir_xt = torch.sqrt(torch.clamp_min(1 - a_prev - sigma ** 2, 0.0)) * eps
            x = torch.sqrt(a_prev) * x0 + dir_xt
            if eta:
                z = noise[i] if noise is not None else torch.randn(shape, generator=generator,
                                                                    device=device)
                x = x + sigma * z * float(t_prev >= 0)
        return x


def cfg_model_fn(model_fn: Callable, guidance_scale: float, null_label: int):
    """Classifier-free guidance wrapper: runs cond + uncond in one batch
    (reference models/model.py forward_with_cfg)."""

    def wrapped(x, t, y, *rest):
        xx = torch.cat([x, x], dim=0)
        tt = torch.cat([t, t], dim=0)
        yy = torch.cat([y, torch.full_like(y, null_label)], dim=0)
        out = model_fn(xx, tt, yy, *rest)
        cond, uncond = torch.chunk(out, 2, dim=0)
        c_eps, c_rest = torch.chunk(cond, 2, dim=1)
        u_eps, _ = torch.chunk(uncond, 2, dim=1)
        eps = u_eps + guidance_scale * (c_eps - u_eps)
        return torch.cat([eps, c_rest], dim=1)

    return wrapped


@torch.no_grad()
def ema_update(ema_params, params, decay: float = 0.9999):
    """EMA of parameters (reference Large-DiT train.py:121-131):
    e <- e * decay + p * (1 - decay) for every leaf, in place (the reference
    returns a new tree; in place keeps one EMA copy in device memory).
    Returns ``ema_params``."""
    from accessory_tpu_torch.train.tree import named_leaves

    pairs = dict(named_leaves(params))
    named = list(named_leaves(ema_params))
    ema = [e for _, e in named]
    src = [pairs[name].detach().to(e.dtype) for name, e in named]
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, torch._foreach_mul(src, 1 - decay))
    return ema_params
