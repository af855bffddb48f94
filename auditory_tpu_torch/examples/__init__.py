"""The JAX package's examples, ported: run each as
``python -m auditory_tpu_torch.examples.<name>``.

- :mod:`.train_phone_classifier` -- synthetic CV tokens -> gabor-kWTA
  features (three routes) -> a 2-layer MLP trained with Adam.
- :mod:`.learnable_frontend` -- mel features -> a gabor bank trained as a
  parameter with a linear head, with checkpoint/resume.
- :mod:`.gabor_view` -- the headless gaborview app over WAV + ``.PHN.MS``
  pairs, with an A/B comparison.
- :mod:`.process_speech` -- the headless processspeech app: one WAV
  through the StreamingProcessor, a summary line per segment.
- :mod:`.serve_streams` -- the multi-stream serving demo: MultiStreamOnline
  with the serving outputs, a transfer tier and bounded buffers.
"""
