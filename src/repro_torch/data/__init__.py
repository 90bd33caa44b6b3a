from .pipeline import FederatedClassification, SyntheticLMStream, make_client_speeds
