"""Clean twin of contract_codec_violations.py."""
import torch

from repro_torch.compress.spec import Codec


class StatelessClean(Codec):
    name = "fx_stateless_clean"

    def encode(self, u, state, gen):
        return {"dense": u}, state

    def decode(self, payload, d):
        return payload["dense"]

    def payload_bytes(self, d):
        return 4 * d


class StatefulClean(Codec):
    name = "fx_stateful_clean"
    stateful = True

    def init_state(self, m, d, device=None):
        return torch.zeros((m, d), device=device)

    def encode(self, u, state, gen):
        acc = u + state
        return {"dense": acc}, acc - acc

    def decode(self, payload, d):
        return payload["dense"]

    def payload_bytes(self, d):
        return 4 * d
