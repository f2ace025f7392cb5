from repro_torch.models.transformer import forward, init_params, lm_loss

__all__ = ["forward", "init_params", "lm_loss"]
