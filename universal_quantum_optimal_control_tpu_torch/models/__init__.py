from . import (grape, pipeline, score_embedding, serialization, two_qubit,  # noqa: F401
               universal_transformer)

from .grape import GRAPE  # noqa: F401

from .pipeline import Pipeline, rotation_vector_from_unitary  # noqa: F401
from .score_embedding import (  # noqa: F401
    euler_yxy_from_rotation_vector,
    score_features,
    score_sequence_from_yxy,
    sinusoidal_positional_encoding,
)
from .serialization import (  # noqa: F401
    load_params_npz,
    load_params_npz_tree,
    params_from_jax,
    params_to_jax,
    save_params_npz,
    transfer_encoder_params,
)
from .two_qubit import (  # noqa: F401
    TwoQubitQOCTransformer,
    makhlin_invariants_ri,
    unitary_tokens,
)
from .universal_transformer import (  # noqa: F401
    UniversalQOCTransformer,
    normalize_pulse_space,
    wrap_angle,
)
