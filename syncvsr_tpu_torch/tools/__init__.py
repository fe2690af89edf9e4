"""Command-line tools of the port, each run as ``python -m
syncvsr_tpu_torch.tools.<name>``.

* Measurement (on the GPU; ``--device cpu`` runs them on the CPU), each
  printing one JSON line with the card's name and power limit:
  ``bench_loader``, ``bench_decode``, ``bench_beam_parts``, ``bench_stem``,
  ``profile_step``, ``bench_bn``, ``bench_aux_workloads``, ``bisect_bs16``;
  ``bn_shapes`` (K1-K4 per shape, for comparing two checkouts).
* Offline data preparation (own copies of the JAX package's): ``roi``,
  ``preprocess_lrw``, ``prepare_lrs``, ``train_spm``, ``transcribe``,
  ``pack_dataset``, ``index_lengths``, ``tokenize_audio``,
  ``import_checkpoint``. The detectors (mediapipe, ultralytics, whisperx)
  are optional and imported at call time.
"""
