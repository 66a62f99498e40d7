"""Pipeline constants of the port, copied from the JAX package's
typed configuration (jegal_tpu/config.py) so the port stands alone.

Each value cites where the reference model pins it."""

# audio front end (reference utils/audio_utils.py:11-17)
SAMPLE_RATE = 16000
N_FFT = 512
WIN_LENGTH = 320
HOP_LENGTH = 160
N_MELS = 80
LOG_OFFSET = 1e-20

# video (reference inference_embs.py:235-283, :488)
WINDOW = 25              # GestSync sync window, frames
EDGE_PAD_FRAMES = 12     # +/-12 edge-repeat pad around a clip

# model (reference models/jegal.py:18)
D_MODEL = 512
D_MODEL_TEXT = 768       # XLM-R base hidden width, the text encoder's d
NUM_HEADS = 8
PE_MAX_LEN = 500
