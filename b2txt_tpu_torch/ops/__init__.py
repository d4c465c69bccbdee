from .gru import GRULayerFn, gru_layer, gru_layer_backward, gru_layer_forward, gru_layer_reference
from .smoothing import gauss_smooth, gaussian_kernel, kernel_array
from .augment import TransformArgs, transform_data
from .ctc import batched_greedy_collapse, ctc_loss, ctc_loss_from_logits, greedy_decode_ids
from .preprocess import fused_preprocess, fused_preprocess_reference
from .gather import row_gather, row_gather_reference
