from .prefix_beam import CtcPrefixBeamSearch, ctc_prefix_beam_search
from .prefix_beam_device import backtrace, beam_search_scan, ctc_prefix_beam_search_device
from .lmbeam import DecodeResult, LexiconBeamSearch, decode_numpy
from .device_lm import DeviceCausalLMRescorer
from .rescore import (
    NGramLLMAdapter,
    TorchCausalLMRescorer,
    augment_nbest,
    get_string_differences,
    llm_rescore,
    llm_rescore_async,
    rescore_nbest_with_ngram,
)


def device_lexicon_beam_search(*args, **kwargs):
    """Lazy constructor for the device-resident searcher
    (``lmbeam_device.DeviceLexiconBeamSearch``)."""
    from .lmbeam_device import DeviceLexiconBeamSearch

    return DeviceLexiconBeamSearch(*args, **kwargs)
