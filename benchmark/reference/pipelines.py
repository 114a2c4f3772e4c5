"""The reference's requests and training steps, end to end, on the plain
model of ``sd2.py``: the prompt tokens (a byte-level CLIP tokenizer without
merges, the id layout the program's vocabulary has), the SD2 schedule and
its DDIM sub-schedule, a 1-reference request from its uint8 photos to its
uint8 results, a multi-view scene, and prompt-tuning steps with AdamW.

Random draws are inputs: the request's start code and step noise come from
``torch.Generator(device).manual_seed(seed)`` in the order the LDM sampler
draws them, the VAE posterior's noise from a generator seeded 42 (the LDM
code re-seeds to 42 before every VAE sample), and a training step's t and
noise from a generator state the benchmark hands over.
"""

from __future__ import annotations

import html
import re

import numpy as np
import torch

from benchmark.reference import sd2

SOT, EOT, VOCAB = 49406, 49407, 49408
VAE_NOISE_SEED = 42


# ---------------------------------------------------------------- prompt tokens


def _byte_chars() -> list:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1)) \
        + list(range(ord("\xae"), ord("\xff") + 1))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return [chr(c) for c in cs], bs


def special_tokens(cfg: dict) -> list:
    """The prompt table's token names in row order: ``repeat`` copies of the
    prompt token, numbered, then (multi-view) ``view_tokens`` view tokens
    for each view, written without their closing bracket as the config's
    code writes them."""
    pr = cfg["prompt"]
    sp = pr["token"]
    names = [sp.replace(">", f"{i}>") for i in range(pr["repeat"])]
    for j in range(cfg.get("view_num") or 0):
        names += [f"<view_direct-{j}-{k}" for k in range(pr["view_tokens"])]
    return names


def prompts(cfg: dict) -> list:
    """The cond prompt of each view (one for the 1-reference model)."""
    pr = cfg["prompt"]
    base = " ".join(special_tokens(cfg)[: pr["repeat"]])
    if not cfg.get("view_num"):
        return [base]
    return [base + "".join(f"<view_direct-{j}-{k}>" for k in range(pr["view_tokens"]))
            for j in range(cfg["view_num"])]


def tokenize(texts: list, specials: list, context: int = 77) -> np.ndarray:
    """CLIP's pre-tokenizer (the table's tokens first), each word's bytes as
    the byte-level vocabulary's ids, the last with its end-of-word form;
    [SOT, ..., EOT], zero-padded, cut to ``context`` with EOT last."""
    chars, order = _byte_chars()
    ids = {c: i for i, c in enumerate(chars)}
    byte_char = dict(zip(order, chars))
    sp_ids = {t: VOCAB + i for i, t in enumerate(specials)}
    sp_ids.update({"<start_of_text>": SOT, "<end_of_text>": EOT})
    pattern = re.compile("|".join(re.escape(t) for t in ["<start_of_text>", "<end_of_text>", *specials])
                         + r"""|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""", re.IGNORECASE)
    out = np.zeros((len(texts), context), np.int64)
    for row, text in enumerate(texts):
        text = re.sub(r"\s+", " ", html.unescape(html.unescape(text)).strip()).strip().lower()
        toks = [SOT]
        for word in pattern.findall(text):
            if word in sp_ids:
                toks.append(sp_ids[word])
                continue
            cs = [byte_char[b] for b in word.encode("utf-8")]
            toks += [ids[c] for c in cs[:-1]] + [256 + ids[cs[-1]]]
        toks.append(EOT)
        if len(toks) > context:
            toks = toks[:context]
            toks[-1] = EOT
        out[row, : len(toks)] = toks
    return out


# ---------------------------------------------------------------- schedule


def schedule(cfg: dict, steps: int, eta: float) -> dict:
    """The SD2 ("linear") schedule in float64, kept as float32, and the
    uniform DDIM sub-schedule of ``steps`` (timesteps range(0, T, T // steps)
    + 1) in descending t."""
    s = cfg["schedule"]
    betas = np.linspace(s["linear_start"] ** 0.5, s["linear_end"] ** 0.5, s["timesteps"], dtype=np.float64) ** 2
    ac = np.cumprod(1.0 - betas).astype(np.float32)
    ts = np.arange(0, s["timesteps"], s["timesteps"] // steps) + 1
    a = ac.astype(np.float64)[ts]
    a_prev = np.concatenate([[ac.astype(np.float64)[0]], a[:-1]])
    sigma = eta * np.sqrt((1 - a_prev) / (1 - a) * (1 - a / a_prev))
    f32 = lambda v: np.asarray(v, np.float32)[::-1].copy()
    return {"t": ts[::-1].copy(), "a": f32(a), "a_prev": f32(a_prev), "s1m": f32(np.sqrt(1.0 - a)),
            "sigma": f32(sigma), "sqrt_ac": np.sqrt(ac.astype(np.float64)).astype(np.float32),
            "sqrt_1m_ac": np.sqrt(1.0 - ac.astype(np.float64)).astype(np.float32)}


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def vae_noise(shape, device) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=torch.Generator(device).manual_seed(VAE_NOISE_SEED), device=device)


# ---------------------------------------------------------------- requests


def predict(weights: dict, cfg: dict, request: dict, sampler: dict, arith: sd2.Arith, device) -> list:
    """One 1-reference request: uint8 ``reference`` and ``source`` photos
    [S, S, 3] and a painted ``mask`` [S, S] (nonzero = hole) at the served
    size S, sampled ``num_samples`` times from ``seed`` -> the inpainted
    targets, uint8 [S, S, 3] each (the composite truncated after clipping)."""
    p = sd2.Params(weights, arith)
    n = request["num_samples"]
    ref = request["reference"].astype(np.float32) / 127.5 - 1.0
    src = request["source"].astype(np.float32) / 127.5 - 1.0
    m = (request["mask"] > 0).astype(np.float32)[..., None]
    image = torch.from_numpy(np.repeat(np.concatenate([ref, src], axis=1)[None], n, axis=0)).to(device)
    mask = torch.from_numpy(np.repeat(np.concatenate([np.zeros_like(m), m], axis=1)[None], n, axis=0)).to(device)
    return [np.clip((r + 1) * 127.5, 0, 255).astype(np.uint8)
            for r in _inpaint(p, cfg, image, mask, prompts(cfg) * n, request["seed"], sampler, 1)[
                :, :, image.shape[2] // 2:].cpu().numpy()]


def scene(weights: dict, cfg: dict, images: torch.Tensor, masks: torch.Tensor, seed: int, index: int,
          sampler: dict, arith: sd2.Arith) -> torch.Tensor:
    """Scene ``index`` of a multi-view call on ``images`` [B, V, H, W, 3] in
    [-1, 1] and ``masks`` [B, V, H, W, 1] seeded ``seed``: its composited
    views [V, H, W, 3].  The call's draws are over all B * V rows; this
    scene's rows are taken from them."""
    p = sd2.Params(weights, arith)
    b, v = images.shape[:2]
    rows = slice(index * v, (index + 1) * v)
    image, mask = images.flatten(0, 1), masks.flatten(0, 1)
    return _inpaint(p, cfg, image, mask, prompts(cfg) * b, seed, sampler, v, rows)


def _inpaint(p, cfg, image, mask, texts, seed, sampler, views, rows=slice(None)):
    """The composite [B, H, W, 3] of rows ``rows`` of an NHWC batch whose
    draws (VAE noise, x_T, step noise) are over the whole batch."""
    dev = image.device
    ds = 2 ** (len(cfg["vae"]["ch_mult"]) - 1)
    b, h, w, _ = image.shape
    sp = special_tokens(cfg)
    tokens = torch.from_numpy(tokenize(texts, sp)).to(dev)[rows]
    uncond = torch.from_numpy(tokenize([""] * b, sp)).to(dev)[rows]
    shape = (b, h // ds, w // ds, cfg["unet"]["out_channels"])
    masked = image * (mask < 0.5)
    z = sd2.vae_encode(p, cfg, nchw(masked[rows]),
                       nchw(vae_noise((b, h // ds, w // ds, cfg["vae"]["z_channels"]), dev)[rows]))
    c_concat = torch.cat([nchw(mask[rows])[:, :, ::ds, ::ds], z], dim=1)
    ctx, uctx = sd2.text_encode(p, cfg, tokens), sd2.text_encode(p, cfg, uncond)
    x = _ddim(p, cfg, c_concat, ctx, uctx, torch.Generator(dev).manual_seed(seed), rows, shape, sampler, views)
    pred = nhwc(sd2.vae_decode(p, cfg, x)).clamp(-1.0, 1.0)
    return pred * mask[rows] + image[rows] * (1.0 - mask[rows])


def _ddim(p, cfg, c_concat, ctx, uctx, generator, rows, shape, sampler, views):
    """DDIM from x_T (the generator's first draw) with CFG over the
    [uncond; cond] batch, each step's noise the generator's next draw; every
    draw is made at the whole batch's NHWC ``shape`` and cut to ``rows``."""
    tab = schedule(cfg, sampler["ddim_steps"], sampler["eta"])
    dev = c_concat.device
    draw = lambda: nchw(torch.randn(shape, generator=generator, device=dev)[rows])
    x = draw()
    cc, cx = torch.cat([c_concat, c_concat]), torch.cat([uctx, ctx])
    for i, t in enumerate(tab["t"]):
        tt = torch.full((2 * x.shape[0],), int(t), dtype=torch.long, device=dev)
        e_u, e_c = sd2.unet(p, cfg, torch.cat([torch.cat([x, x]), cc], dim=1), tt, cx, views=views).chunk(2)
        e = e_u + sampler["scale"] * (e_c - e_u)
        a, a_prev, s1m, sig = (torch.tensor(float(tab[k][i]), device=dev) for k in ("a", "a_prev", "s1m", "sigma"))
        x0 = (x - s1m * e) / torch.sqrt(a)
        x = torch.sqrt(a_prev) * x0 + torch.sqrt(torch.clamp(1.0 - a_prev - sig ** 2, min=0.0)) * e + sig * draw()
    return x


# ---------------------------------------------------------------- prompt tuning


TABLE = "cond_stage_model.special_embeddings.weight"


def train_steps(weights: dict, cfg: dict, batches: list, generator_states: list, arith: sd2.Arith,
                device, keep=()) -> dict:
    """Prompt-tuning steps from the drawn weights: step s on ``batches[s]``
    (NHWC ``image``, ``mask``, ``masked_image``, ``tokens``) with t and the
    noise drawn from a generator in ``generator_states[s]`` (t first, then
    the noise), the loss the mean squared eps error, the gradient reaching
    the prompt table alone, then AdamW.  Returns the first gradient, the
    table before and after, and the table after each step in ``keep``
    (``tables``, by step)."""
    opt, sched = cfg["train"], schedule(cfg, 1, 0.0)
    table0 = weights[TABLE].to(torch.float32)
    table = table0.clone().requires_grad_(True)
    p = sd2.Params(weights, arith, override={TABLE: table})
    m, v = torch.zeros_like(table0), torch.zeros_like(table0)
    b1, b2 = opt["betas"]
    out = {"table0": table0, "tables": {}}
    sqrt_ac, sqrt_1m = (torch.from_numpy(sched[k]).to(device) for k in ("sqrt_ac", "sqrt_1m_ac"))
    for step, (batch, state) in enumerate(zip(batches, generator_states), start=1):
        gen = torch.Generator(device)
        gen.set_state(state)
        image = batch["image"].to(torch.float32)
        bsz = image.shape[0]
        ds = 2 ** (len(cfg["vae"]["ch_mult"]) - 1)
        lat = (bsz, image.shape[1] // ds, image.shape[2] // ds, cfg["vae"]["z_channels"])
        t = torch.randint(0, cfg["schedule"]["timesteps"], (bsz,), generator=gen, device=device)
        noise = nchw(torch.randn(lat, generator=gen, device=device, dtype=torch.float32))
        with torch.no_grad():
            z = sd2.vae_encode(p, cfg, nchw(image), nchw(vae_noise(lat, device)))
            zm = sd2.vae_encode(p, cfg, nchw(batch["masked_image"].to(torch.float32)), nchw(vae_noise(lat, device)))
            c_concat = torch.cat([nchw(batch["mask"].to(torch.float32))[:, :, ::ds, ::ds], zm], dim=1)
            x_noisy = sqrt_ac[t][:, None, None, None] * z + sqrt_1m[t][:, None, None, None] * noise
        ctx = sd2.text_encode(p, cfg, batch["tokens"].to(torch.long))
        ctx_leaf = ctx.detach().requires_grad_(True)
        for r in range(bsz):  # the batch mean, one row's graph at a time
            eps = sd2.unet(p, cfg, torch.cat([x_noisy[r:r + 1], c_concat[r:r + 1]], dim=1), t[r:r + 1],
                           ctx_leaf[r:r + 1])
            (((eps - noise[r:r + 1]) ** 2).mean() / bsz).backward()
        ctx.backward(ctx_leaf.grad)
        g = table.grad.detach().clone()
        table.grad = None
        out.setdefault("grad1", g)
        with torch.no_grad():
            table.mul_(1 - opt["lr"] * opt["weight_decay"])
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            denom = v.sqrt() / (1 - b2 ** step) ** 0.5 + opt["eps"]
            table.sub_(opt["lr"] / (1 - b1 ** step) * m / denom)
        if step in keep:
            out["tables"][step] = table.detach().clone()
    return {**out, "table": table.detach()}
