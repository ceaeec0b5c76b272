from .basic import confusion_loss, cosine_similarity_loss, mse_loss, nll_loss
from .mi import ClusterMI, GroupSamplingMI, MILoss, cosine_distance_matrix
