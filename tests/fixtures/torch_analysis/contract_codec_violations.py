"""Seeded codec contract violations (CONTRACT012), NOT registered (no
``@register_codec``)."""
import torch

from repro_torch.compress.spec import Codec


class MissingEncode(Codec):                  # VIOLATION CONTRACT012
    name = "fx_missing_encode"

    def decode(self, payload, d):
        return payload["dense"]

    def payload_bytes(self, d):
        return 4 * d


class StatefulWithoutState(Codec):           # VIOLATION CONTRACT012
    name = "fx_stateful_without_state"
    stateful = True                          # ...but no init_state below

    def encode(self, u, state, gen):
        return {"dense": u}, state

    def decode(self, payload, d):
        return payload["dense"]

    def payload_bytes(self, d):
        return 4 * d


class StateWithoutFlag(Codec):               # VIOLATION CONTRACT012
    name = "fx_state_without_flag"
    stateful = False                         # hides the residual

    def init_state(self, m, d, device=None):
        return torch.zeros((m, d), device=device)

    def encode(self, u, state, gen):
        return {"dense": u + state}, state

    def decode(self, payload, d):
        return payload["dense"]

    def payload_bytes(self, d):
        return 4 * d
