from .basic import (classification_error, confusion_loss, cosine_similarity_loss, ctc_loss, kldiv_loss,
                    l1_loss, mse_loss, nll_loss)
from .mi import ClusterMI, GroupSamplingMI, MILoss, cosine_distance_matrix
