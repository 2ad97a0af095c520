"""Frontend: milliseconds of the program's frontend/patch spans (a
backend patch applied to the document's objects, frontend/__init__.py
`_apply_patch_to_doc`) per session of the window. The stage spans run in
the load's replay of the base change and in the merge alike, so this
counts both."""


def read(r):
    sessions = len(r.seconds("session"))
    if "frontend.patch" not in r.obs_spans or not sessions:
        return None
    return r.obs_seconds("frontend.patch") * 1e3 / sessions
