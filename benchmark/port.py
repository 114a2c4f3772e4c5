"""The system under test: the program's bundle built from a configuration
file's sizes, with the benchmark's weights loaded into it.  This is the
only file of the benchmark's own code, besides the traffic drivers, that
imports the program."""

from __future__ import annotations

import warnings

import torch


def build_model(cfg: dict, weights: dict, device, remat: bool = False):
    """The program's ``LeftRefillModel`` of ``cfg`` in its compute dtype
    (the multi-view UNet where ``view_num`` is set), built on ``meta``,
    placed on ``device`` and filled from ``weights`` (every key, strictly)."""
    from leftrefill_torch.diffusion.core import LeftRefillModel
    from leftrefill_torch.diffusion.schedules import DiffusionSchedule
    from leftrefill_torch.models.autoencoder import AutoencoderKL, DDConfig
    from leftrefill_torch.models.clip import PromptCLIPEmbedder
    from leftrefill_torch.models.multiview import MultiViewUnetModel
    from leftrefill_torch.models.unet import UNetModel

    from benchmark.reference.sd2 import prompt_table_rows

    dtype = getattr(torch, cfg["dtype"])
    u, v, t, s = cfg["unet"], cfg["vae"], cfg["text"], cfg["schedule"]
    ukw = dict(in_channels=u["in_channels"], model_channels=u["model_channels"], out_channels=u["out_channels"],
               num_res_blocks=u["num_res_blocks"], attention_resolutions=tuple(u["attention_resolutions"]),
               channel_mult=tuple(u["channel_mult"]), num_head_channels=u["num_head_channels"],
               transformer_depth=1, context_dim=u["context_dim"], dtype=dtype, remat=remat)
    with torch.device("meta"):
        unet = MultiViewUnetModel(view_num=cfg["view_num"], **ukw) if cfg.get("view_num") else UNetModel(**ukw)
        vae = AutoencoderKL(DDConfig(z_channels=v["z_channels"], in_channels=v["in_channels"], out_ch=v["out_ch"],
                                     ch=v["ch"], ch_mult=tuple(v["ch_mult"]), num_res_blocks=v["num_res_blocks"]),
                            embed_dim=v["embed_dim"], dtype=dtype)
        text = PromptCLIPEmbedder(vocab_size=t["vocab_size"], width=t["width"], heads=t["heads"], layers=t["layers"],
                                  context_length=t["context_length"], num_special_tokens=prompt_table_rows(cfg),
                                  dtype=dtype, layer="penultimate" if t["skip_last"] else "last")
        model = LeftRefillModel(unet, vae, text, DiffusionSchedule.create(
            timesteps=s["timesteps"], beta_schedule="linear", linear_start=s["linear_start"],
            linear_end=s["linear_end"]), scale_factor=s["scale_factor"])
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model.eval()


def tokenizer(cfg: dict):
    """The program's tokenizer of the configuration's prompt set-up:
    (tokenizer, special tokens, the view prompts or None)."""
    from leftrefill_torch.models.clip import build_multiview_prompt_tokenizer, build_prompt_tokenizer

    pr = cfg["prompt"]
    with warnings.catch_warnings():  # no BPE merges file: the byte-level vocabulary, as the benchmark wants
        warnings.simplefilter("ignore")
        if cfg.get("view_num"):
            return build_multiview_prompt_tokenizer(cfg["view_num"])
        tok, sp, _ = build_prompt_tokenizer([f"repeat_{pr['repeat']}_{pr['token']}"], None)
        return tok, sp, None
