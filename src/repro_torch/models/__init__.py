from repro_torch.models.transformer import DecoderLM, build_model, param_count

__all__ = ["DecoderLM", "build_model", "param_count"]
