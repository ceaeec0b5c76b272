from .basic import confusion_loss, cosine_similarity_loss, mse_loss, nll_loss
