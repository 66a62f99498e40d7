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

# evaluation: the similarity temperature of every eval task (reference
# evaluate_spotting.py:39, evaluate_asd.py:43, plot_heatmap.py:34); the
# spotting thresholds (evaluation/evaluate_spotting.py:13-14), the ASD
# candidate counts (evaluate_asd.py) and the heatmap overlay
# (plot_heatmap.py), as the JAX package's EvalConfig holds them
TEMPERATURE = 0.07
SPOT_THRESHOLD = 0.5          # a spotted word's attention must reach this
SPOT_FRAME_THRESHOLD = 9      # frames of slack around the true word span
ASD_SPEAKERS = (2, 4, 6)      # candidate counts the accuracy is read at
HEATMAP_THRESHOLD = 0.8       # attention below it is drawn faint
HEATMAP_ALPHA = 0.6           # overlay weight of the thresholded heatmap

# speaker preprocessing: the tracker and crop constants (reference
# preprocess/inference_preprocess.py:18-27, the tracker's :70-123 and the
# crop's :314-330)
IOU_THRESHOLD = 0.5      # a detection joins a track above this IOU
MIN_TRACK = 10           # a track keeps more than this many frames
MIN_FRAME_SIZE = 64      # ... and a mean box side above this, in pixels
NUM_FAILED_DET = 25      # frames a track may miss before it ends
DETECTOR_CONF = 0.6      # person detections at or below it are dropped
CROP_SCALE = 0.0
TIGHT_SCALE = 0.9        # the smoothed box's scale
MEDFILT_KERNEL = 13      # the median filter over a track's boxes
