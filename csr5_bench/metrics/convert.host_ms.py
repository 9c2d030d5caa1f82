"""The host clock around ``build_csr5`` of the configuration's matrix,
ended by a device synchronisation, after an untimed small conversion:
what a user pays once per matrix."""


def read(t):
    return t.convert_ms
