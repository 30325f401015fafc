from repro_torch.data.lm import LMStream, markov_stream

__all__ = ["LMStream", "markov_stream"]
