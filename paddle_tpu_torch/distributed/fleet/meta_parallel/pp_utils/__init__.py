"""pp_utils (Paddle's `fleet/meta_parallel/pp_utils`): the pipeline's
point-to-point transfers (`p2p_communication`)."""
from . import p2p_communication  # noqa: F401
