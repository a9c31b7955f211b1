"""tpu_se — a JAX speech enhancement framework.

A from-scratch JAX/XLA re-design of the 3-stage DNN speech-enhancement
pipeline from "Using Generalized Gaussian Distributions to Improve Regression
Error Modeling for Deep-Learning-Based Speech Enhancement"
(reference: LiChaiUSTC/Speech-enhancement-based-on-a-maximum-likelihood-criterion).

Layers (mirroring the reference's four process layers, see SURVEY.md §1):

- ``tpu_se.io``     — wav / HTK / pfile / .norm / .wts codecs (the reference's
                       file-format "public API", byte-for-byte compatible).
- ``tpu_se.dsp``    — LPS analysis (STFT as one GEMM) and noisy-phase
                       overlap-add synthesis + SegSNR/LSD metrics.
- ``tpu_se.data``   — pfile chunk planner / loader, Z-score normalizer,
                       7-frame context splicing, host prefetch pipeline.
- ``tpu_se.models`` — the FFN regression model (pure pytree params).
- ``tpu_se.losses`` — beta-norm and ML-GGD objectives with reference-parity
                       gradient semantics.
- ``tpu_se.train``  — jit/scan training engine, momentum-SGD, checkpointing.
- ``tpu_se.parallel`` — device mesh / sharding / multi-host helpers.
- ``tpu_se.infer``  — batch decode (wav -> enhanced wav + metrics).
- ``tpu_se.cli``    — command-line entry points mirroring the reference CLIs.
"""

__version__ = "0.1.0"
