"""Evaluation helpers beside ``vitok_torch.scripts.eval_vae``: the baseline VAEs."""
