/* A fatal-signal handler that prints the native stack of the faulting
 * thread to stderr, for hosts without gdb or core files.
 *
 *     cc -shared -fPIC -O1 -o libsegv_backtrace.so scripts/segv_backtrace.c
 *     LD_PRELOAD=./libsegv_backtrace.so python -X faulthandler ...
 *
 * Installed when the library loads, before the interpreter starts, so
 * Python's faulthandler takes the signal first, dumps every thread's
 * Python stack, puts this handler back and raises the signal again: this
 * handler then prints the frames glibc's unwinder finds through the
 * signal frames, the faulting one among them (library, symbol where
 * exported, offset, address; the fault address too when it takes the
 * first signal), and ends the process with the signal's default
 * action. scripts/torch_mesh_repeat.py builds it and runs the mesh card
 * tests under it. */
#define _GNU_SOURCE
#include <execinfo.h>
#include <signal.h>
#include <string.h>
#include <unistd.h>

static void say(const char *s) { (void)!write(2, s, strlen(s)); }

static void say_hex(unsigned long v) {
  char buf[19] = "0x";
  int i;
  for (i = 0; i < 16; i++)
    buf[2 + i] = "0123456789abcdef"[(v >> (60 - 4 * i)) & 15];
  buf[18] = 0;
  say(buf);
}

static void on_fatal(int sig, siginfo_t *info, void *ctx) {
  void *frames[96];
  int n;
  (void)ctx;
  say("\n--- native backtrace: signal ");
  say(sig == SIGSEGV ? "SIGSEGV" : sig == SIGBUS ? "SIGBUS"
      : sig == SIGILL ? "SIGILL" : sig == SIGFPE ? "SIGFPE" : "other");
  if (info->si_code > 0) { /* raised by the fault, not again by raise() */
    say(", fault address ");
    say_hex((unsigned long)info->si_addr);
  }
  say(" ---\n");
  n = backtrace(frames, 96);
  backtrace_symbols_fd(frames, n, 2);
  say("--- end of native backtrace ---\n");
  signal(sig, SIG_DFL);
  raise(sig);
}

__attribute__((constructor)) static void install(void) {
  static const int sigs[] = {SIGSEGV, SIGBUS, SIGILL, SIGFPE};
  struct sigaction sa;
  void *warm[1];
  unsigned i;
  backtrace(warm, 1); /* loads the unwinder now, not inside the handler */
  memset(&sa, 0, sizeof sa);
  sa.sa_sigaction = on_fatal;
  sa.sa_flags = SA_SIGINFO | SA_NODEFER;
  sigemptyset(&sa.sa_mask);
  for (i = 0; i < sizeof sigs / sizeof sigs[0]; i++)
    sigaction(sigs[i], &sa, 0);
}
