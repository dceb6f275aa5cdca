"""DSP front-end library.

The reference's DSP suite was deleted from its tree and survives only as a
test contract (SURVEY.md §2.4): `test_dsp_functions.py:13-20` and
`test_sps_modes.py:8` import `rrc_filter`, `matched_filter`, `extract_symbols`,
`timing_recovery_gardner`, `timing_recovery_mueller_muller`,
`simple_timing_recovery` from `plot_preprocessing_signal`. This package
implements that contract for real, JAX-first:

  * tap generation and filtering are pure jnp (fusable into the model's jit)
  * Gardner / Mueller-Müller are sequential error-feedback loops -> lax.scan
    with fixed-capacity outputs + valid masks (static shapes under jit)
  * energy / correlation phase pickers are fully vectorized

plus the normalization/reshape helpers retained in the reference's
`plot_preprocessing_signal.py:72-187` and the batched fused front-end that
feeds the models.
"""

from vitiq.dsp.taps import rrc_filter  # noqa: F401
from vitiq.dsp.filtering import matched_filter  # noqa: F401
from vitiq.dsp.timing import (  # noqa: F401
    simple_timing_recovery,
    timing_recovery_gardner,
    timing_recovery_mueller_muller,
)
from vitiq.dsp.frontend import (  # noqa: F401
    apply_normalization,
    extract_symbols,
    preprocess_batch_amplitude_phase, preprocess_batch_mdf,
    preprocess_batch_rawiq,
    preprocess_batch_sps,
    preprocess_batch_spectrogram,
    preprocess_batch_vit_spectrogram,
    preprocess_batch_vit,
    preprocess_for_transformer,
    preprocess_for_vit,
)
