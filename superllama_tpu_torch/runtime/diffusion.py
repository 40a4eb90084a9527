"""Diffusion-LM generation loop (LLaDA / Dream / RND1).

Counterpart of the JAX package's ``runtime/diffusion.py`` (the reference's
examples/diffusion/diffusion-cli.cpp): start from [prompt | MASK …]; each
step runs the whole bidirectional forward over the fixed (1, max_length)
window, samples every masked position on the host and commits the most
confident ones by the schedule:

- schedules: timestep (continuous-time transfer probability) or block
  (LLaDA's blocks, ``_num_transfer_tokens``);
- algorithms: confidence, entropy, margin, random, origin;
- classifier-free guidance (the prompt masked for the unconditional pass),
  gumbel noise, Dream's shifted logits and a stochastic transfer
  (``alg_temp``).

The forward runs on the model's device, eagerly, one call a step (two with
guidance); its f32 logits come to the host, where the scheduling and
sampling are the JAX package's numpy code line for line: the same
``np.random.default_rng(seed)`` draws in the same order, so equal logits
give equal tokens.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

CONFIDENCE_BASED = "confidence"
ENTROPY_BASED = "entropy"
MARGIN_BASED = "margin"
RANDOM = "random"
ORIGIN = "origin"

TIMESTEP_BASED = "timestep"
BLOCK_BASED = "block"


@dataclass
class DiffusionParams:
    steps: int = 64
    max_length: int = 128
    mask_token_id: int = 0
    algorithm: str = CONFIDENCE_BASED
    schedule: str = TIMESTEP_BASED
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eps: float = 0.0
    block_length: int = 32
    alg_temp: float = 0.0
    cfg_scale: float = 0.0
    shift_logits: bool = False    # Dream: position p reads logits[p - 1]
    add_gumbel_noise: bool = False
    seed: int = 0


def _num_transfer_tokens(mask_count: int, steps: int) -> list[int]:
    base, rem = divmod(mask_count, steps)
    return [base + (1 if i < rem else 0) for i in range(steps)]


def _transfer_count(step, steps, remaining, schedule, eps, per_step):
    if schedule == TIMESTEP_BASED:
        t = 1.0 - step / steps * (1.0 - eps)
        s = 1.0 - (step + 1) / steps * (1.0 - eps)
        p = (1.0 - s / t) if step < steps - 1 else 1.0
        return int(remaining * p)
    if per_step and step < len(per_step):
        return per_step[step]
    return remaining // (steps - step)


def _filter_sample(logits: np.ndarray, p: DiffusionParams,
                   rng: np.random.Generator) -> tuple[int, np.ndarray, np.ndarray]:
    """top-k / top-p / temperature filter and sample: (token, the kept
    probabilities sorted, their ids)."""
    x = logits.astype(np.float64)
    order = np.argsort(-x)
    if p.top_k > 0:
        order = order[: p.top_k]
    probs = np.exp(x[order] - x[order][0])
    probs /= probs.sum()
    if p.top_p < 1.0:
        keep = np.searchsorted(np.cumsum(probs), p.top_p) + 1
        order, probs = order[:keep], probs[:keep]
        probs /= probs.sum()
    if p.temperature > 0.0:
        probs = probs ** (1.0 / p.temperature)
        probs /= probs.sum()
        idx = rng.choice(len(order), p=probs)
    else:
        idx = 0
    return int(order[idx]), probs, order


def _confidence(algorithm: str, sel_idx: int, probs: np.ndarray,
                rng: np.random.Generator) -> float:
    if algorithm in (CONFIDENCE_BASED, ORIGIN):
        return float(probs[sel_idx])
    if algorithm == ENTROPY_BASED:
        return float(np.sum(probs * np.log(probs + 1e-10)))  # −entropy
    if algorithm == MARGIN_BASED:
        return float(probs[0] - probs[1]) if len(probs) > 1 else float(probs[0])
    return float(rng.uniform())


def diffusion_generate(forward_fn, params, hp, input_tokens: list[int],
                       dp: DiffusionParams, step_callback=None) -> list[int]:
    """The full max_length window (prompt + generated tokens). ``forward_fn``
    is a registry forward ``(params, hp, tokens, pos, cache) -> (logits,
    cache)``, run on the device of ``params["token_embd"]``."""
    n_input = len(input_tokens)
    assert dp.max_length > n_input
    tokens = np.full(dp.max_length, dp.mask_token_id, np.int64)
    tokens[:n_input] = input_tokens
    rng = np.random.default_rng(dp.seed)

    dev = params["token_embd"].device
    pos = torch.arange(dp.max_length, dtype=torch.int32, device=dev)[None]

    @torch.no_grad()
    def fwd(t: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(t[None], dtype=torch.int64, device=dev)
        return forward_fn(params, hp, x, pos, None)[0][0].to(torch.float32).cpu().numpy()

    if dp.schedule == BLOCK_BASED:
        assert dp.max_length % dp.block_length == 0
        n_blocks = dp.max_length // dp.block_length
        assert dp.steps % n_blocks == 0
        steps_per_block = dp.steps // n_blocks
    else:
        n_blocks, steps_per_block = 1, dp.steps

    for block in range(n_blocks):
        if dp.schedule == BLOCK_BASED:
            b0 = n_input + block * dp.block_length
            b1 = min(n_input + (block + 1) * dp.block_length, dp.max_length)
            per_step = _num_transfer_tokens(
                int(np.sum(tokens[b0:b1] == dp.mask_token_id)), steps_per_block)
        else:
            b0, b1, per_step = 0, dp.max_length, []

        for step in range(steps_per_block):
            mask_pos = [i for i in range(b0, b1) if tokens[i] == dp.mask_token_id]
            if not mask_pos:
                break
            if step_callback:
                step_callback(block * steps_per_block + step, dp.steps, tokens)

            logits = fwd(tokens)
            if dp.cfg_scale > 0.0:
                un = tokens.copy()
                un[:n_input] = dp.mask_token_id
                un_logits = fwd(un)
                logits = un_logits + (dp.cfg_scale + 1.0) * (logits - un_logits)

            def pos_logits(i):
                if dp.shift_logits:
                    return logits[max(i - 1, 0)]
                return logits[i]

            if dp.add_gumbel_noise and dp.temperature > 0.0:
                noise = rng.uniform(1e-20, 1.0, logits.shape)
                logits = np.exp(logits) / np.power(-np.log(noise), dp.temperature)

            n_transfer = _transfer_count(step, steps_per_block, len(mask_pos),
                                         dp.schedule, dp.eps, per_step)
            if dp.algorithm == ORIGIN:
                p_trans = n_transfer / len(mask_pos)
                for i in mask_pos:
                    if rng.uniform() < p_trans:
                        tok, _, _ = _filter_sample(pos_logits(i), dp, rng)
                        tokens[i] = tok
                continue

            sampled, confs = [], []
            for i in mask_pos:
                x = pos_logits(i).astype(np.float64)
                order = np.argsort(-x)
                if dp.top_k > 0:
                    order = order[: dp.top_k]
                probs = np.exp(x[order] - x[order][0])
                probs /= probs.sum()
                if dp.top_p < 1.0:
                    keep = int(np.searchsorted(np.cumsum(probs), dp.top_p)) + 1
                    order, probs = order[:keep], probs[:keep]
                    probs /= probs.sum()
                if dp.temperature > 0.0:
                    pt = probs ** (1.0 / dp.temperature)
                    pt /= pt.sum()
                    sel = rng.choice(len(order), p=pt)
                else:
                    sel = 0
                sampled.append(int(order[sel]))
                confs.append(_confidence(dp.algorithm, sel, probs, rng))

            if n_transfer <= 0:
                continue
            if dp.alg_temp <= 0.0:
                pick = sorted(range(len(confs)), key=lambda j: (-confs[j], j))[:n_transfer]
            else:  # stochastic transfer: softmax(conf / alg_temp)
                w = np.asarray(confs) / dp.alg_temp
                w = np.exp(w - w.max())
                w /= w.sum()
                pick = rng.choice(len(confs), size=min(n_transfer, len(confs)),
                                  replace=False, p=w)
            for j in pick:
                tokens[mask_pos[j]] = sampled[j]

    return [int(t) for t in tokens]
