from .params import EncoderControl, FrameState
