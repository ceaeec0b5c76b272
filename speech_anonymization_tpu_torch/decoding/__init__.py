from .ctc_prefix import CTCPrefixState, ctc_advance_state, ctc_init_state, ctc_score_candidates
from .beam_search import BeamSearchConfig, beam_search, hyps_to_lists

__all__ = [
    "CTCPrefixState",
    "ctc_init_state",
    "ctc_score_candidates",
    "ctc_advance_state",
    "BeamSearchConfig",
    "beam_search",
    "hyps_to_lists",
]
