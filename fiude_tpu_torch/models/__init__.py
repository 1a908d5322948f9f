from fiude_tpu_torch.models.nn import (
    MLP, elu_mlp, relu_mlp, relu_mlp_standard, init_linear_, init_linear_normal_,
)
from fiude_tpu_torch.models.encoders import (
    BackGRUEncoder, BiGRUEncoder, BiLSTMEncoder, GenericEncoder, MISOGRUEncoder,
    sir_scaler_vector, split_mean_std,
)
from fiude_tpu_torch.models.decoder import LinearDecoder
from fiude_tpu_torch.models.rhs import SIRRates, NeuralAug, UDE
from fiude_tpu_torch.models.bayes import (
    BayesNeuralAug,
    BayesSIRRates,
    BayesUDE,
    DenseVariational,
    variational_elu_mlp,
    variational_kl,
)
from fiude_tpu_torch.models.vae import (
    UDEForecaster, ForwardExtras, make_prior, reparam, resolve_device,
)
