"""DSP layer: LPS analysis and noisy-phase overlap-add synthesis.

Re-design of the reference's ETSI front-end / vocoder
(``Feature_prepare/SourceCode_Wav2LogSpec_be``,
``Test_code/SourceCode_LogSpec2Wav_be``): the per-frame split-radix FFT
becomes one batched windowed-DFT matmul; OLA becomes a vectorized
segment-sum.  Semantics (framing, window, log floor, OLA weights) match the
reference exactly — see each module's docstring for the file:line citations.
"""

from tpu_se.dsp.analysis import (
    FRAME_LENGTH, FRAME_SHIFT, FFT_LENGTH, NUM_BINS, LOG_FLOOR,
    hamming_window, num_frames, frame_signal, lps_from_frames, wav_to_lps,
    mel_filterbank, dct_matrix, mfcc_from_frames, wav_to_mfcc,
    RATE_CONFIGS, rate_config,
)
from tpu_se.dsp.synthesis import reconstruct, lps_to_wav
from tpu_se.dsp.metrics import segsnr, lsd, power_spectra

__all__ = [
    "FRAME_LENGTH", "FRAME_SHIFT", "FFT_LENGTH", "NUM_BINS", "LOG_FLOOR",
    "hamming_window", "num_frames", "frame_signal", "lps_from_frames",
    "wav_to_lps", "reconstruct", "lps_to_wav", "segsnr", "lsd",
    "power_spectra", "mel_filterbank", "dct_matrix", "mfcc_from_frames",
    "wav_to_mfcc", "RATE_CONFIGS", "rate_config",
]
